"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files under benchmark/."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(text_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    everything = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"])
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 2 <= len(e2e) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["moves"] in e2e and text_ok(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert per
        assert {m["moves"] for m in per} <= set(e2e)
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert (harness.BENCH_DIR / "drivers"
            / f"{c.traffic['driver']}.py").exists()
    assert (harness.BENCH_DIR / "families"
            / f"{c.config['family']}.py").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.metrics("per_layer"):
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_config_files_state_what_they_run():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"] and cfg["precision"] and cfg["control"]
