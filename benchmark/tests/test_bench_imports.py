"""Nothing the benchmark or its reference loads is JAX or the JAX
package, compared by whole top-level names; the reference loads nothing
of the program."""

import ast
import subprocess
import sys

from benchmark import harness
from benchmark.run import FORBIDDEN, forbidden_modules


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "diner_tpu_torch_like", sys)
    assert "diner_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "diner_tpu.x", sys)
    assert "diner_tpu" in forbidden_modules()


def test_no_source_under_benchmark_imports_jax():
    for path in harness.BENCH_DIR.rglob("*.py"):
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert not tops & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert "diner_tpu_torch" not in tops, path
        assert tops <= {"__future__", "benchmark", "torch", "math",
                        "dataclasses", "typing", "contextlib", "functools",
                        "numpy"}, (path, tops)


def test_a_dry_run_loads_no_forbidden_module():
    """Every driver, family and reader of a tiny CPU run, in a fresh
    process: what it loaded, compared whole."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.run import forbidden_modules\n"
        "class MP:\n"
        "    def setattr(self, o, n, v): setattr(o, n, v)\n"
        "tiny.cpu_stubs(MP())\n"
        "from benchmark.harness import workload_names\n"
        "for name in workload_names():\n"
        "    cell = tiny.tiny_cell(name)\n"
        "    cell.driver.run(cell, tiny.args(trace=1), 0.0, device='cpu')\n"
        "print('FOUND', forbidden_modules())\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
