"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs.

Imports neither JAX nor tests/conftest.py's fixtures, so it also runs where
JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_kernels_gpu.py

Without a card every test here skips."""

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import random_scene
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as b1
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import render
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _binned(dev, cfg, opacity=None):
    scene = random_scene(3000, sh_degree=3, seed=8, extent=2.0,
                         mean_scale=0.05)
    if opacity is not None:
        scene.opacity.fill_(opacity)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    splats = project(scene.to(dev), view, cam.get_project_matrix(), eye, cfg)
    return binning.bin_splats(splats, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,opacity", [
    (RenderMode.SH3, None), (RenderMode.BILLBOARD, None),
    (RenderMode.FLAT_BALL, None), (RenderMode.GAUSSIAN_BALL, None),
    (RenderMode.SH3, 0.99),
])
def test_tile_raster_fwd_matches_plain(mode, opacity):
    """B1 at 1e-5 * max(1, |plain|): the kernel compiles with -fmad=false,
    so only the rgb sums' order differs from the plain version."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, mode=mode)
    bs = _binned(dev, cfg, opacity)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    before = b1.tile_raster_fwd.launches
    rgb, trans = b1.tile_raster_fwd(*args)
    torch.cuda.synchronize()
    assert b1.tile_raster_fwd.launches == before + 1
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    for got, want in ((rgb, prgb), (trans, ptrans)):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol, mode


@pytest.mark.gpu
def test_tile_raster_fwd_band_matches_plain():
    """An interleaved shard (global tile rows 1, 3, 5, 7): the kernel maps
    its blocks to pixel rows through row_offset / row_stride."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192)
    scene = random_scene(3000, sh_degree=3, seed=8, extent=2.0,
                         mean_scale=0.05)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    splats = project(scene.to(dev), view, cam.get_project_matrix(), eye, cfg)
    bs = binning.bin_splats(splats, cfg, row_offset=1, local_rows=4,
                            row_stride=2)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 1, cfg, 4, 2)
    rgb, trans = b1.tile_raster_fwd(*args)
    torch.cuda.synchronize()
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    assert float(prgb.max()) > 0.1
    for got, want in ((rgb, prgb), (trans, ptrans)):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol


@pytest.mark.gpu
def test_render_on_card_matches_cpu():
    """The whole slice on the card against the same render on the CPU."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192)
    scene = random_scene(3000, sh_degree=3, seed=9, extent=2.0,
                         mean_scale=0.05)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    gpu = render(scene, view, cam.get_project_matrix(), eye, cfg, device=dev)
    cpu = render(scene, view, cam.get_project_matrix(), eye, cfg,
                 device="cpu")
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=2e-4)
