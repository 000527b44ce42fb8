"""PyTorch port: compare_backends, kernel against oracle, on the golden
10k scene at 1160x522 (tests/test_golden.py's scene and eye), next to the
JAX package's own tile backend against its oracle.

Both tile paths order a tile's splats by a 20-bit depth key and then by
splat id (ops/binning.py in both packages), the oracles by exact depth, so
overlapping splats of near-equal depth blend in another order in a few
pixels: max_abs is far above 1e-4 in the reference itself, while the mean
stays near 3e-5 and the PSNR near 60 dB.  chip_smoke.py gates the card's
run on the mean and the PSNR (and on max_abs 1e-4 on the flip harness's
scene); this test pins that the port reproduces the reference's reading."""

import numpy as np

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.eval.compare import (
    compare_backends as jax_compare,
)
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.eval.compare import compare_backends
from torch_port_util import port_cfg, port_scene

REF_W, REF_H = 1160, 522


def test_golden_kernel_vs_oracle_matches_the_reference():
    scene = random_scene(10_000, sh_degree=3, seed=5, extent=3.0,
                         mean_scale=0.04, anisotropy=0.7).pad_to_multiple(1024)
    cam = Camera(h=REF_H, w=REF_W)
    cam.fovy = 1.0
    eye = np.array([0.5, -0.4, 6.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = cam.get_project_matrix()
    cfg = JaxConfig(width=REF_W, height=REF_H)
    want = jax_compare(scene.to_device(), view, proj, eye, cfg,
                       backends=("tile", "oracle"))
    got = compare_backends(port_scene(scene), view, proj, eye, port_cfg(cfg),
                           ("kernel", "oracle"), device="cpu")
    ref, ours = want["tile_vs_oracle"], got["kernel_vs_oracle"]

    # the reference misses max_abs 1e-4 on this scene by itself ...
    assert ref["max_abs"] > 0.1
    # ... and the port's images are the reference's, pixel for pixel
    for mine, theirs in (("kernel", "tile"), ("oracle", "oracle")):
        w = want["images"][theirs]
        atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got["images"][mine], w, atol=atol, rtol=0)
    # so the port's reading is the reference's, and inside chip_smoke's gate
    assert abs(ours["max_abs"] - ref["max_abs"]) <= 1e-4
    assert abs(ours["mean_abs"] - ref["mean_abs"]) <= 1e-7
    assert abs(ours["psnr"] - ref["psnr"]) <= 0.01
    for r in (ref, ours):
        assert r["mean_abs"] <= 1e-4 and r["psnr"] >= 50.0
