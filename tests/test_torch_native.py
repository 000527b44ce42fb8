"""PyTorch port: the native host data path (csrc/gsv_native.cpp through
native/): the PLY load bit-equal to the numpy reader and to the JAX
package's numpy reader, the PNG writers round-tripping, the build kept in
the port's _build/, and the fallbacks when the library is missing."""

import numpy as np
import pytest

from gaussiansplattingviewer_tpu.models import random_scene as jax_random
from gaussiansplattingviewer_tpu.models import save_ply as jax_save_ply
from gaussiansplattingviewer_tpu.models.ply import load_ply as jax_load_ply
from gaussiansplattingviewer_tpu_torch import native
from gaussiansplattingviewer_tpu_torch.models import ply
from gaussiansplattingviewer_tpu_torch.utils import image_io

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")


def _needs_native():
    """Skip (decided in the test, not at import) without g++ or zlib."""
    if native.get_lib() is None:
        pytest.skip(f"native library unavailable: {native.status()}")


def _fields(scene):
    return {f: getattr(scene, f).numpy() for f in FIELDS}


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_native_ply_bit_equal(tmp_path, degree):
    _needs_native()
    path = tmp_path / "s.ply"
    jax_save_ply(jax_random(1000, sh_degree=degree, seed=13 + degree), path)
    nat = ply._load_ply_native(path)
    assert nat is not None
    scene_n, bbox_n, center_n = nat
    scene_p, bbox_p, center_p = ply.load_ply(path, use_native=False)
    jax_scene, jax_bbox, jax_center = jax_load_ply(path, use_native=False)
    for f, a in _fields(scene_n).items():
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, getattr(scene_p, f).numpy(), f)
        np.testing.assert_array_equal(a, np.asarray(getattr(jax_scene, f)),
                                      f)
    for got, want, jwant in ((bbox_n, bbox_p, jax_bbox),
                             (center_n, center_p, jax_center)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jwant)
    # load_ply takes the native path by default and gives the same bits
    default, _, _ = ply.load_ply(path)
    for f, a in _fields(default).items():
        np.testing.assert_array_equal(a, _fields(scene_n)[f])


def test_native_ply_layouts_fall_back(tmp_path):
    """Files the native reader does not take (ascii, or an SH degree above
    max_sh_degree) go to the numpy reader, which loads or raises as
    before."""
    _needs_native()
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\n"
        + "".join(f"property float {p}\n" for p in (
            "x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
            "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2",
            "rot_3"))
        + "end_header\n"
        + "0 0 0 0.1 0.2 0.3 0.5 -2 -2 -2 1 0 0 0\n"
        + "1 1 1 0.1 0.2 0.3 -0.5 -1 -1 -1 0 1 0 0\n")
    assert ply._load_ply_native(ascii_ply) is None
    scene, _, _ = ply.load_ply(ascii_ply)
    assert len(scene) == 2
    deg3 = tmp_path / "d3.ply"
    jax_save_ply(jax_random(50, sh_degree=3, seed=1), deg3)
    assert ply._load_ply_native(deg3, max_sh_degree=1) is None
    with pytest.raises(ValueError):
        ply.load_ply(deg3, max_sh_degree=1)


def test_native_build_stays_in_the_port():
    _needs_native()
    path = native.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "gaussiansplattingviewer_tpu_torch"
    assert native.status().startswith("native")


def test_png_writers_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
    disp = rng.uniform(0, 1, (23, 41)).astype(np.float32)
    image_io.write_rgb8(tmp_path / "a.png", img)
    image_io.write_disparity16(tmp_path / "d.png", disp)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.png"), img)
    back = image_io.read_image(tmp_path / "d.png")
    np.testing.assert_array_equal(
        back.astype(np.uint16),
        np.clip(disp * 65535, 0, 65535).astype(np.uint16))


def test_fallback_without_the_library(tmp_path, monkeypatch):
    """No native library: PLY loads and PNG writes take the numpy / PIL
    paths with the same results."""
    path = tmp_path / "s.ply"
    jax_save_ply(jax_random(200, sh_degree=1, seed=2), path)
    want = _fields(ply.load_ply(path)[0])
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert ply._load_ply_native(path) is None
    for f, a in _fields(ply.load_ply(path)[0]).items():
        np.testing.assert_array_equal(a, want[f])
    img = np.random.default_rng(3).integers(0, 256, (9, 7, 3), np.uint8)
    image_io.write_rgb8(tmp_path / "a.png", img)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.png"), img)
    pil = image_io._PILImage
    monkeypatch.setattr(image_io, "_PILImage", None)  # the numpy writer
    image_io.write_disparity16(tmp_path / "d.png", np.full((4, 5), 0.5))
    with pil.open(tmp_path / "d.png") as im:
        np.testing.assert_array_equal(np.array(im),
                                      np.full((4, 5), 32767, np.uint16))
