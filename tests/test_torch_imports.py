"""The PyTorch port stands alone: no module of it, nor chip_smoke.py,
imports jax or the JAX package (gaussiansplattingviewer_tpu)."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "gaussiansplattingviewer_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_imports_no_jax():
    files = sorted((ROOT / "gaussiansplattingviewer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), n) for p in files
           for n in _imports(p) if _forbidden(n)]
    assert not bad, bad


def test_forbidden_match_is_exact():
    assert _forbidden("jax.numpy")
    assert _forbidden("gaussiansplattingviewer_tpu.ops.render")
    assert not _forbidden("gaussiansplattingviewer_tpu_torch.ops.render")
    assert not _forbidden("jaxtyping_like")
