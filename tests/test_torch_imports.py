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
    # the apps, host utilities, eval and native I/O: the JAX modules' names
    "gaussiansplattingviewer_tpu_torch.apps.viewer": (
        "MODE_NAMES", "find_ply", "load_scene", "build_parser", "main"),
    "gaussiansplattingviewer_tpu_torch.apps.dataset_gen": (
        "build_parser", "triplet_paths", "generate", "main"),
    "gaussiansplattingviewer_tpu_torch.apps.render_all": (
        "build_parser", "main"),
    "gaussiansplattingviewer_tpu_torch.apps.serve": (
        "ViewerState", "build_state", "make_handler", "main"),
    "gaussiansplattingviewer_tpu_torch.utils.profiling": (
        "trace", "hard_sync", "FrameTimer", "render_stats"),
    "gaussiansplattingviewer_tpu_torch.utils.camera": (
        "Camera", "sphere_orbit_pose", "sphere_orbit_path"),
    "gaussiansplattingviewer_tpu_torch.utils.transforms": (
        "rotmat_to_quat", "quat_to_rotmat", "look_at"),
    "gaussiansplattingviewer_tpu_torch.utils.image_io": (
        "write_rgb8", "write_disparity16", "read_image", "ensure_dirs"),
    "gaussiansplattingviewer_tpu_torch.models.checkpoint": (
        "latest_step", "save_npz", "load_npz"),
    "gaussiansplattingviewer_tpu_torch.native": (
        "GsvPlyInfo", "get_lib", "status"),
    "gaussiansplattingviewer_tpu_torch.eval": (
        "psnr", "ssim", "mse", "lpips_available", "lpips_distance",
        "blur_effect", "remove_statistical_outliers", "disparity_to_depth",
        "disparity_to_pointcloud", "sharpen_disparity"),
    "gaussiansplattingviewer_tpu_torch.eval.metrics": (
        "mse", "psnr", "ssim", "compare_image_dirs"),
    "gaussiansplattingviewer_tpu_torch.eval.blur": (
        "blur_effect", "blur_scores_for_dir"),
    "gaussiansplattingviewer_tpu_torch.eval.outliers": (
        "remove_statistical_outliers", "outlier_score",
        "disparity_outlier_metric"),
    "gaussiansplattingviewer_tpu_torch.eval.reproject": (
        "disparity16_to_pixels", "disparity_to_depth",
        "disparity_to_pointcloud", "save_pointcloud_ply"),
    "gaussiansplattingviewer_tpu_torch.eval.sharpen": (
        "flying_pixel_mask", "sharpen_disparity"),
    "gaussiansplattingviewer_tpu_torch.eval.disp_scale": (
        "bilinear_sample", "match_keypoints_sift",
        "disparity_scale_from_matches", "calibrate_disparity_scale"),
    "gaussiansplattingviewer_tpu_torch.eval.packaging": (
        "check_scene_files", "zip_scene", "zip_all_scenes", "unzip_all"),
    "gaussiansplattingviewer_tpu_torch.eval.plots": (
        "moving_average", "plot_blur_scores", "plot_chunked_median",
        "plot_outlier_scores"),
    "gaussiansplattingviewer_tpu_torch.eval.viz": (
        "normalize_depth_for_display", "colormap_disparity",
        "stereo_shift_check", "radial_undistort", "normalize_blur_csv",
        "plot_camera_path"),
    "gaussiansplattingviewer_tpu_torch.eval.lpips_metric": (
        "lpips_available", "lpips_distance"),
    "gaussiansplattingviewer_tpu_torch.eval.compare": (
        "compare_backends", "main"),
    # scripts/tpu_gradcheck.py's names
    "gaussiansplattingviewer_tpu_torch.eval.gradcheck": (
        "run_case", "main"),
    # the measurement entry points: bench.py, scripts/ply_roundtrip_tpu.py
    # and scripts/scaling.py
    "gaussiansplattingviewer_tpu_torch.bench": ("main",),
    "gaussiansplattingviewer_tpu_torch.eval.ply_roundtrip": ("main",),
    "gaussiansplattingviewer_tpu_torch.eval.scaling": ("main",),
}


@pytest.mark.parametrize("name", sorted(NEW_MODULES))
def test_new_modules_import_without_a_card(name):
    """Importing the compaction, parallel, app, utility, eval and native
    modules needs no card and no process group, and gives the JAX modules'
    names."""
    import importlib

    mod = importlib.import_module(name)
    missing = [n for n in NEW_MODULES[name] if not hasattr(mod, n)]
    assert not missing, missing
    path = pathlib.Path(mod.__file__)
    assert not [n for n in _imports(path) if _forbidden(n)]


def test_importing_the_port_pulls_in_no_optional_dependency():
    """In a fresh interpreter, importing every module of the port loads
    neither JAX nor the JAX package, nor scipy, OpenCV or matplotlib (eval
    imports those on first use)."""
    import subprocess
    import sys

    mods = sorted(NEW_MODULES) + ["gaussiansplattingviewer_tpu_torch.apps.train"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'gaussiansplattingviewer_tpu', 'scipy', "
              "'cv2', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
