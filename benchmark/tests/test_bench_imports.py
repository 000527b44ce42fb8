"""Nothing the benchmark runs is JAX or the JAX package, judged by each
module's top-level name compared whole (the port's name starts with the
JAX package's): in the harness's sources, and in the modules a run of a
cell leaves loaded."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.run import FORBIDDEN

HERE = Path(__file__).resolve().parents[1]


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_cell_imports_no_primitive():
    # the scene, the reference and its work counts reach a run only
    # through the module its configuration names
    tree = ast.parse((HERE / "cell.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            assert not name.startswith(("benchmark.reference",
                                        "benchmark.scene")), name


def test_a_run_loads_no_jax():
    code = (
        "import time, sys\n"
        "from benchmark import cell, cells, run\n"
        "from benchmark.tests.conftest import toy, ROOT\n"
        "spec = cells.Spec(ROOT)\n"
        "for w in ('garden-train', 'garden-view'):\n"
        "    c = spec.cell(w)\n"
        "    config = spec.config(c['config'])\n"
        "    cell.run(toy(config), spec.reference(config),"
        " spec.traffic(c['traffic']), spec.limits(w), 5, 0.2, False,"
        " 'cpu', time.perf_counter())\n"
        "print(run.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    before = set(sys.modules)
    sys.modules["gaussiansplattingviewer_tpu_torch_probe"] = object()
    try:
        from benchmark.run import loaded_forbidden

        assert "gaussiansplattingviewer_tpu" not in loaded_forbidden() \
            or any(m.split(".")[0] == "gaussiansplattingviewer_tpu"
                   for m in before)
    finally:
        del sys.modules["gaussiansplattingviewer_tpu_torch_probe"]
