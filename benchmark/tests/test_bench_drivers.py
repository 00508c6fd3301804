"""Each traffic driver end to end at a tiny size on the CPU, with the
CUDA calls stood in for (``tiny.cpu_stubs``): set-up, the window or the
traced stretch, the per-layer readers, the reference and the numbers
compared. The cells are those of ``BENCHMARK.json``."""

import math

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", harness.workload_names())
def test_driver_dry_run(monkeypatch, name, trace):
    tiny.cpu_stubs(monkeypatch)
    cell = tiny.tiny_cell(name)
    res = cell.driver.run(cell, tiny.args(seed=2 ** 31 + 7, seconds=0.2,
                                          trace=trace), 0.0, device="cpu")
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(cell.limits) <= set(res["readings"])
    assert all(math.isfinite(v) for v in res["readings"].values())
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    if trace:
        got = harness.read_per_layer(cell, res["trace_ctx"])
        # the CPU trace holds no device op, so no kernel's roofline
        want = {m["name"] for m in cell.metrics("per_layer")
                if "roofline" not in m["name"]}
        assert set(got) == want
    else:
        assert set(res["out"]) == e2e


def test_same_seed_same_feeds():
    from benchmark.drivers import train_step
    cell = tiny.tiny_cell("novel_pe_facescape.train")
    a, b = (train_step.make_pool(cell, 11, "cpu") for _ in range(2))
    c = train_step.make_pool(cell, 12, "cpu")
    for k, v in a[0]["batch"].items():
        assert (v == b[0]["batch"][k]).all(), k
        assert v.shape == c[0]["batch"][k].shape
    assert not (a[0]["batch"]["src_rgbs"] == c[0]["batch"]["src_rgbs"]).all()
    assert all((x == y).all() for x, y in zip(a[1]["noise"], b[1]["noise"]))
