"""On the card, at each cell's own size: the control (the reference in
the configuration's control precision, put in the program's place) comes
out not correct on three seeds, and the program correct. The cells are
those of ``BENCHMARK.json``.

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda -q

on the chip machine (a few minutes a cell)."""

import argparse

import pytest

from benchmark import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", harness.workload_names())
def test_control_fails_and_program_passes(cuda, name):
    cell = harness.load_cell(name)
    for seed in SEEDS:
        r = cell.driver.calibrate(cell, seed, argparse.Namespace(
            control=True, witness=False, faults=False, dump=False))
        assert harness.verdict(r["program"], cell.limits)[0], r
        assert not harness.verdict(r["control"], cell.limits)[0], r
