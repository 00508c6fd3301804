"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have (its traffic driver's ``FAULTS``), planted in
the program at a tiny size on the CPU, read against the cell's own
limits. The cells are those of ``BENCHMARK.json``."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

CASES = [(name, f) for name in harness.workload_names()
         for f in harness.load_cell(name).driver.FAULTS]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_comes_out_not_correct(monkeypatch, name, fault):
    tiny.cpu_stubs(monkeypatch)
    cell = tiny.tiny_cell(name)
    fault(monkeypatch)
    res = cell.driver.run(cell, tiny.args(seed=9, seconds=0.1), 0.0,
                          device="cpu")
    correct, checks = harness.verdict(res["readings"], cell.limits)
    assert not correct, checks
