"""PyTorch port on the card: each CUDA kernel (B1, B2, B3) against its plain
PyTorch version on the same inputs, and a render gradient on the card
against the same gradient on the CPU.

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
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_bwd as b3
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as b1
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import render
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _binned(dev, cfg, opacity=None, **band):
    scene = random_scene(3000, sh_degree=3, seed=8, extent=2.0,
                         mean_scale=0.05)
    if opacity is not None:
        scene.opacity.fill_(opacity)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    splats = project(scene.to(dev), view, cam.get_project_matrix(), eye, cfg)
    return binning.bin_splats(splats, cfg, **band)


def _close(got, want):
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= tol


CASES = [(RenderMode.SH3, None), (RenderMode.BILLBOARD, None),
         (RenderMode.FLAT_BALL, None), (RenderMode.GAUSSIAN_BALL, None),
         (RenderMode.SH3, 0.99)]
# an interleaved shard: global tile rows 1, 3, 5, 7
BAND = dict(row_offset=1, local_rows=4, row_stride=2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,opacity", CASES)
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


def _train_args(dev, cfg, opacity=None, band=None):
    if band is None:
        bs = _binned(dev, cfg, opacity)
        return (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    bs = _binned(dev, cfg, opacity, **band)
    return (bs.table, bs.tile_starts, bs.tile_counts, band["row_offset"],
            cfg, band["local_rows"], band["row_stride"])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,opacity,band", [
    *((m, o, None) for m, o in CASES), (RenderMode.SH3, None, BAND)])
def test_tile_raster_fwd_train_matches_plain(mode, opacity, band):
    """B2: rgb and T at 1e-5 * max(1, |plain|); nproc and the whole ckpt
    buffer equal (both write the same windows with the same sequential
    products)."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, mode=mode)
    args = _train_args(dev, cfg, opacity, band)
    before = b1.tile_raster_fwd_train.launches
    rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    torch.cuda.synchronize()
    assert b1.tile_raster_fwd_train.launches == before + 1
    prgb, ptrans, pckpt, pnproc = b1.tile_raster_fwd_train_plain(*args)
    assert _close(rgb, prgb) and _close(trans, ptrans)
    assert torch.equal(nproc, pnproc)
    assert torch.equal(ckpt, pckpt)
    if opacity is not None:  # the opaque scene stops early somewhere
        s = args[1].to(torch.int64)
        nch = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
        assert bool((nproc.to(torch.int64) < nch).any())


@pytest.mark.gpu
@pytest.mark.parametrize("mode,opacity,band", [
    *((m, o, None) for m, o in CASES), (RenderMode.SH3, None, BAND)])
def test_tile_raster_bwd_matches_plain(mode, opacity, band):
    """B3 per table column within 1e-5 * max|plain column|: the kernel and
    its plain version share t_i and alpha bit for bit and differ only in
    the order of the per-row sums over 256 pixels (and of the suffix)."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, mode=mode)
    args = _train_args(dev, cfg, opacity, band)
    _, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    gen = torch.Generator(device="cpu").manual_seed(3)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen).to(dev)
    g_trans = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    table, starts, counts, row_offset, *rest = args
    bwd_args = (table, starts, counts, nproc, ckpt, row_offset, g_rgb,
                g_trans, trans, *rest)
    before = b3.tile_raster_bwd.launches
    g = b3.tile_raster_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert b3.tile_raster_bwd.launches == before + 1
    pg = b3.tile_raster_bwd_plain(*bwd_args)
    assert float(pg.abs().max()) > 0
    for c in range(16):
        scale = float(pg[c].abs().max())
        assert float((g[c] - pg[c]).abs().max()) <= 1e-5 * scale, c
    # run to run the same bits: no atomics, fixed summation order
    assert torch.equal(g, b3.tile_raster_bwd(*bwd_args))


@pytest.mark.gpu
def test_render_gradient_on_card_matches_cpu():
    """The training path on the card (B2, B3, the fold, projection
    autograd) against the same gradient on the CPU.  Per field within
    1e-4 * max|g| (measured 5e-7 on an H100): the CPU takes exp in f64
    rounded to f32, the card expf, so an alpha_min fragment can flip, and
    the card's index_add_ adds in another order."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, grad_fold_bf16=False)
    scene = random_scene(3000, sh_degree=3, seed=9, extent=2.0,
                         mean_scale=0.05)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    grads = []
    for d in (dev, torch.device("cpu")):
        sc = scene.to(d)
        leaves = [sc.xyz, sc.rot, sc.scale, sc.opacity, sc.sh]
        for t in leaves:
            t.requires_grad_(True)
        img = render(sc, view, cam.get_project_matrix(), eye, cfg, device=d)
        (img * img).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for name, g_card, g_cpu in zip(("xyz", "rot", "scale", "opacity", "sh"),
                                   *grads):
        scale = float(g_cpu.abs().max())
        assert scale > 0, name
        err = float((g_card - g_cpu).abs().max())
        print(f"{name}: max|card - cpu| / max|g| = {err / scale:.3e}")
        assert err <= 1e-4 * scale, name
