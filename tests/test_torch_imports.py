"""The PyTorch port stands alone: no module of it, nor chip_smoke.py,
imports jax or the JAX package (gaussiansplattingviewer_tpu)."""

import ast
import pathlib

import pytest

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


NEW_MODULES = {
    "gaussiansplattingviewer_tpu_torch.ops.compaction": (
        "compact_by_mask", "pack_splats", "unpack_splats", "compact_splats"),
    "gaussiansplattingviewer_tpu_torch.parallel.mesh": (
        "initialize_distributed", "make_mesh", "make_host_mesh",
        "replicate_scene"),
    "gaussiansplattingviewer_tpu_torch.parallel.sharded_render": (
        "band_precull_mask", "make_sharded_render_fn",
        "make_sharded_train_step", "render_sharded", "shard_scene_splats"),
    # the JAX package's parallel/__init__.py names, less put_global (each
    # rank holds its own tensors: see parallel/mesh.py)
    "gaussiansplattingviewer_tpu_torch.parallel": (
        "initialize_distributed", "make_mesh", "make_host_mesh",
        "replicate_scene", "render_sharded", "shard_scene_splats",
        "make_sharded_render_fn", "make_sharded_train_step"),
}


@pytest.mark.parametrize("name", sorted(NEW_MODULES))
def test_new_modules_import_without_a_card(name):
    """Importing the compaction and parallel modules needs no card and no
    process group, and gives the JAX modules' names."""
    import importlib

    mod = importlib.import_module(name)
    missing = [n for n in NEW_MODULES[name] if not hasattr(mod, n)]
    assert not missing, missing
    path = pathlib.Path(mod.__file__)
    assert not [n for n in _imports(path) if _forbidden(n)]
