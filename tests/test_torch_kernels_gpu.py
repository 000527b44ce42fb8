"""PyTorch port on the card: each CUDA kernel (B1-B5) against its plain
PyTorch version on the same inputs, the kernels' resources as built, and
render gradients (classic and fused) on the card against the same
gradients on the CPU.

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


def _render_gradient_card_vs_cpu(dev, cfg, backend="kernel", rel=1e-4):
    """The gradient of sum(img^2) through ``backend`` on the card and on
    the CPU, per field within ``rel`` * max|g|; returns both images."""
    scene = random_scene(3000, sh_degree=3, seed=9, extent=2.0,
                         mean_scale=0.05)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    grads, imgs = [], []
    for d in (dev, torch.device("cpu")):
        sc = scene.to(d)
        leaves = [sc.xyz, sc.rot, sc.scale, sc.opacity, sc.sh]
        for t in leaves:
            t.requires_grad_(True)
        img = render(sc, view, cam.get_project_matrix(), eye, cfg,
                     backend=backend, device=d)
        (img * img).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
        imgs.append(img.detach().cpu())
    for name, g_card, g_cpu in zip(("xyz", "rot", "scale", "opacity", "sh"),
                                   *grads):
        scale = float(g_cpu.abs().max())
        assert scale > 0, name
        err = float((g_card - g_cpu).abs().max())
        print(f"{name}: max|card - cpu| / max|g| = {err / scale:.3e}")
        assert err <= rel * scale, name
    return imgs


@pytest.mark.gpu
def test_render_gradient_on_card_matches_cpu():
    """The training path on the card (B2, B3, the fold, projection
    autograd) against the same gradient on the CPU.  Per field within
    1e-4 * max|g| (measured 5e-7 on an H100): the CPU takes exp in f64
    rounded to f32, the card expf, so an alpha_min fragment can flip, and
    the card's index_add_ adds in another order."""
    _render_gradient_card_vs_cpu(
        _card(), RenderConfig(width=320, height=192, grad_fold_bf16=False))


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 32])
def test_render_gradient_at_tile_8_and_32_on_card_matches_cpu(ts):
    """The classic training path at tile 8 and 32 on the card (B2 and B3
    once each) against the CPU's, as at tile 16."""
    dev = _card()
    before = (b1.tile_raster_fwd_train.launches, b3.tile_raster_bwd.launches)
    _render_gradient_card_vs_cpu(
        dev, RenderConfig(width=320, height=192, tile_size=ts,
                          grad_fold_bf16=False))
    assert (b1.tile_raster_fwd_train.launches,
            b3.tile_raster_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_tile_backend_on_card_matches_cpu(ts):
    """render(backend="tile"), the tile executor in plain PyTorch, on the
    card against the same render on the CPU: the image within 1e-5 and
    the gradient of sum(img^2) per field within 1e-5 * max|g|; no kernel
    launches."""
    dev = _card()
    fns = (b1.tile_raster_fwd, b1.tile_raster_fwd_train,
           b1.tile_raster_fwd_seeded, b3.tile_raster_bwd,
           b3.tile_raster_bwd_fused)
    before = [fn.launches for fn in fns]
    card, cpu = _render_gradient_card_vs_cpu(
        dev, RenderConfig(width=320, height=192, tile_size=ts,
                          grad_fold_bf16=False), backend="tile", rel=1e-5)
    assert [fn.launches for fn in fns] == before
    assert float(cpu.max()) > 0.1
    assert float((card - cpu).abs().max()) <= 1e-5


def _seeded_args(dev, cfg, opacity=None, band=None):
    """B4's inputs: a binned table (row 15 a distinct id per column) and a
    seeded t_init, some tiles entering already saturated."""
    table, starts, counts, row_offset, cfg, *rest = _train_args(
        dev, cfg, opacity, band)
    table = table.detach().clone()
    table[15] = torch.arange(table.shape[1], dtype=torch.float32,
                             device=dev)
    num_tiles = counts.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(5)
    t_init = 0.2 + 0.8 * torch.rand((num_tiles, cfg.tile_size ** 2),
                                    generator=gen)
    t_init[::7] = 5e-5
    return (table, starts, counts, t_init.to(dev), row_offset, cfg, *rest)


@pytest.mark.gpu
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode,opacity,band", [
    *((m, o, None) for m, o in CASES), (RenderMode.SH3, None, BAND)])
def test_tile_raster_fwd_seeded_matches_plain(mode, opacity, band, train):
    """B4: rgb at 1e-5 * max(1, |plain|); T, nproc and the whole ckpt
    buffer equal."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, mode=mode)
    args = _seeded_args(dev, cfg, opacity, band)
    before = b1.tile_raster_fwd_seeded.launches
    out = b1.tile_raster_fwd_seeded(*args, train=train)
    torch.cuda.synchronize()
    assert b1.tile_raster_fwd_seeded.launches == before + 1
    plain = b1.tile_raster_fwd_seeded_plain(*args, train=train)
    assert _close(out[0], plain[0])
    for got, want in zip(out[1:], plain[1:]):
        assert torch.equal(got, want)


def _fused_bwd_args(dev, cfg, opacity=None, band=None):
    from gaussiansplattingviewer_tpu_torch.ops.fused import _regions

    args = _seeded_args(dev, cfg, opacity, band)
    table, starts, counts, t_init, row_offset, _, *rest = args
    _, trans, ckpt, nproc = b1.tile_raster_fwd_seeded(*args, train=True)
    num_tiles = counts.shape[0]
    np_c, goff, need, _ = _regions(starts, counts, nproc, 1 << 30, num_tiles)
    gen = torch.Generator(device="cpu").manual_seed(3)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen).to(dev)
    g_trans = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    suffix = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    return (table, starts, counts, np_c, goff, ckpt, row_offset, g_rgb,
            g_trans, trans, suffix, t_init, int(need) + 512, cfg, *rest)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,opacity,band", [
    *((m, o, None) for m, o in CASES), (RenderMode.SH3, None, BAND)])
def test_tile_raster_bwd_fused_matches_plain(mode, opacity, band):
    """B5 per row within 1e-5 * max|plain row|, the id row equal; the
    same bits from run to run."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, mode=mode)
    args = _fused_bwd_args(dev, cfg, opacity, band)
    before = b3.tile_raster_bwd_fused.launches
    g = b3.tile_raster_bwd_fused(*args)
    torch.cuda.synchronize()
    assert b3.tile_raster_bwd_fused.launches == before + 1
    pg = b3.tile_raster_bwd_fused_plain(*args)
    assert float(pg[:9].abs().max()) > 0
    assert torch.equal(g[15], pg[15])
    for c in range(15):
        scale = float(pg[c].abs().max())
        assert float((g[c] - pg[c]).abs().max()) <= 1e-5 * scale, c
    assert torch.equal(g, b3.tile_raster_bwd_fused(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("prefix", [0, 256])
def test_fused_render_gradient_on_card_matches_cpu(prefix):
    """The fused path (B2, B4, B5 twice, the id fold) on the card against
    the same gradient on the CPU, per field within 1e-4 * max|g| (the
    classic test's budget and reasons; index_add_ adds in f64 here)."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, grad_fold_bf16=False,
                       fused_grad=True, prefix_rows=prefix,
                       residual_budget_rows=65536 if prefix else 0)
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


def _scaled_binned(dev, cfg, mean_scale):
    """A scene of large (every band live on most rows) or tiny (most
    (row, band) pairs culled) splats, binned."""
    scene = random_scene(3000, sh_degree=3, seed=12, extent=2.0,
                         mean_scale=mean_scale)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.2, 0.1, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    splats = project(scene.to(dev), view, cam.get_project_matrix(), eye, cfg)
    return binning.bin_splats(splats, cfg)


def _scaled_bwd_args(dev, cfg, mean_scale):
    """B3's inputs on the ``_scaled_binned`` scene."""
    bs = _scaled_binned(dev, cfg, mean_scale)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    _, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    gen = torch.Generator(device="cpu").manual_seed(4)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen).to(dev)
    g_trans = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    return (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, 0, g_rgb,
            g_trans, trans, cfg)


def _assert_rows_close(g, pg, ncols):
    for c in range(ncols):
        scale = float(pg[c].abs().max())
        assert float((g[c] - pg[c]).abs().max()) <= 1e-5 * scale, c


@pytest.mark.gpu
@pytest.mark.parametrize("mean_scale", [0.3, 0.01], ids=["large", "tiny"])
def test_tile_raster_bwd_splat_sizes_match_plain(mean_scale):
    """B3 and B5 where the warp cull keeps nearly every (row, band) pair
    and where it drops most of them: per row within 1e-5 * max|plain row|,
    and the same bits from launch to launch."""
    from gaussiansplattingviewer_tpu_torch.ops.fused import _regions

    dev = _card()
    cfg = RenderConfig(width=320, height=192)
    args = _scaled_bwd_args(dev, cfg, mean_scale)
    g = b3.tile_raster_bwd(*args)
    torch.cuda.synchronize()
    pg = b3.tile_raster_bwd_plain(*args)
    assert float(pg.abs().max()) > 0
    _assert_rows_close(g, pg, 16)
    assert torch.equal(g, b3.tile_raster_bwd(*args))

    table, starts, counts, nproc, ckpt, _, g_rgb, g_trans, trans, _ = args
    table = table.detach().clone()
    table[15] = torch.arange(table.shape[1], dtype=torch.float32, device=dev)
    np_c, goff, need, _ = _regions(starts, counts, nproc, 1 << 30,
                                   counts.shape[0])
    gen = torch.Generator(device="cpu").manual_seed(6)
    suffix = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    fargs = (table, starts, counts, np_c, goff, ckpt, 0, g_rgb, g_trans,
             trans, suffix, torch.ones_like(trans), int(need) + 256, cfg)
    g5 = b3.tile_raster_bwd_fused(*fargs)
    torch.cuda.synchronize()
    pg5 = b3.tile_raster_bwd_fused_plain(*fargs)
    assert torch.equal(g5[15], pg5[15])
    _assert_rows_close(g5, pg5, 15)
    assert torch.equal(g5, b3.tile_raster_bwd_fused(*fargs))


@pytest.mark.gpu
def test_tile_raster_bwd_fused_drops_writes_past_budget():
    """B5 with grad_rows at half of what the tiles' regions need: writes
    past the budget are dropped (a tile straddling it keeps its first
    columns), as in the plain version."""
    from gaussiansplattingviewer_tpu_torch.ops.fused import _regions

    dev = _card()
    cfg = RenderConfig(width=320, height=192)
    args = _fused_bwd_args(dev, cfg)
    table, starts, counts, np_c, goff, *rest = args
    need = int(_regions(starts, counts, np_c, 1 << 30, counts.shape[0])[2])
    budget = need // 2 + 37  # not a multiple of 256: a region straddles it
    small = (*args[:12], budget, *args[13:])
    g = b3.tile_raster_bwd_fused(*small)
    torch.cuda.synchronize()
    pg = b3.tile_raster_bwd_fused_plain(*small)
    assert g.shape == (16, budget)
    assert torch.equal(g[15], pg[15])
    _assert_rows_close(g, pg, 15)
    full = b3.tile_raster_bwd_fused(*args)
    assert torch.equal(g, full[:, :budget])
    assert float(full[:, budget:].abs().max()) > 0  # something was dropped


@pytest.mark.gpu
@pytest.mark.parametrize("mean_scale", [0.3, 0.01], ids=["large", "tiny"])
def test_tile_raster_fwd_splat_sizes_match_plain(mean_scale):
    """B1, B2 and B4 (both variants) where the warp cull keeps nearly every
    (row, band) pair and where it drops most of them: rgb within 1e-5 *
    max(1, |plain|), T, nproc and ckpt equal."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192)
    bs = _scaled_binned(dev, cfg, mean_scale)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    gen = torch.Generator(device="cpu").manual_seed(7)
    t_init = 0.2 + 0.8 * torch.rand((cfg.num_tiles, 256), generator=gen)
    t_init[::5] = 5e-5
    seeded = (bs.table, bs.tile_starts, bs.tile_counts, t_init.to(dev), 0,
              cfg)
    for kernel, plain, a, kw in (
            (b1.tile_raster_fwd, b1.tile_raster_fwd_plain, args, {}),
            (b1.tile_raster_fwd_train, b1.tile_raster_fwd_train_plain, args,
             {}),
            (b1.tile_raster_fwd_seeded, b1.tile_raster_fwd_seeded_plain,
             seeded, {"train": False}),
            (b1.tile_raster_fwd_seeded, b1.tile_raster_fwd_seeded_plain,
             seeded, {"train": True})):
        out = kernel(*a, **kw)
        torch.cuda.synchronize()
        want = plain(*a, **kw)
        assert float(want[0].abs().max()) > 0.1
        assert _close(out[0], want[0]), kernel.__name__
        for got, ref in zip(out[1:], want[1:]):
            assert torch.equal(got, ref), kernel.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("train,seeded", [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=["B1", "B2", "B4", "B4_train"])
def test_tile_raster_fwd_resources(train, seeded):
    """The forward template as built: no spills, the 12,544 bytes of static
    shared memory of csrc/tile_raster_fwd.cu, and 8 CTAs per SM."""
    _card()
    for mode in (RenderMode.SH3, RenderMode.BILLBOARD, RenderMode.FLAT_BALL,
                 RenderMode.GAUSSIAN_BALL):
        occ = b1.kernel_occupancy(mode, train, seeded)
        print(mode, occ)
        assert occ["local_bytes"] == 0, occ
        assert occ["smem_bytes"] == 12544, occ
        assert occ["ctas_per_sm"] == 8, occ


# the forward's shared memory per CTA and CTAs per SM at tile 8 (one
# 128-row block staged at a time, one-warp CTAs up to the SM's 32) and 32
# (the 256-row window, 16-bit masks; 2 CTAs of 512 threads)
FWD_SMEM = {8: 6272, 32: 12800}
FWD_CTAS = {8: 32, 32: 2}
# the backward's shared memory per CTA and CTAs per SM by tile size
# (csrc/tile_raster_bwd.cu): 16 warps per SM at 16 and 32 (two band-sum
# buffers at 32), shared memory holding 14 one-warp CTAs at 8 (128-row
# staged blocks, 8-row sub-blocks)
BWD_SMEM = {8: 14768, 16: 55824, 32: 195200}
BWD_CTAS = {8: 14, 16: 4, 32: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_tile_raster_bwd_resources(fused):
    """The backward template as built: no spills, the shared memory layout
    of csrc/tile_raster_bwd.cu (55,824 bytes at 16, 14,768 at 8, 195,200
    at 32) and its CTAs per SM (4, 14 and 1), for B3 at tile 8, 16 and 32
    and B5 at 16."""
    _card()
    for ts in (16,) if fused else (8, 16, 32):
        for mode in (RenderMode.SH3, RenderMode.BILLBOARD):
            occ = b3.kernel_occupancy(mode, fused, ts)
            print(ts, mode, occ)
            assert occ["local_bytes"] == 0, occ
            assert occ["smem_bytes"] == BWD_SMEM[ts], occ
            assert occ["ctas_per_sm"] == BWD_CTAS[ts], occ


@pytest.mark.gpu
@pytest.mark.parametrize("ts,width,height", [(8, 160, 96), (32, 150, 90)])
@pytest.mark.parametrize("mode,opacity", CASES)
def test_inference_kernels_take_tile_8_and_32(ts, width, height, mode,
                                              opacity):
    """B1 and B4 (train=False) at tile sizes 8 and 32, as the TPU kernel
    takes them: rgb at 1e-5 * max(1, |plain|), T equal; one launch each;
    no spills."""
    dev = _card()
    cfg = RenderConfig(width=width, height=height, mode=mode, tile_size=ts)
    args = _train_args(dev, cfg, opacity)
    before = b1.tile_raster_fwd.launches
    rgb, trans = b1.tile_raster_fwd(*args)
    torch.cuda.synchronize()
    assert b1.tile_raster_fwd.launches == before + 1
    assert tuple(rgb.shape) == (cfg.num_tiles, ts * ts, 3)
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    assert float(prgb.max()) > 0.1
    assert _close(rgb, prgb) and _close(trans, ptrans)
    seeded = _seeded_args(dev, cfg, opacity)
    before = b1.tile_raster_fwd_seeded.launches
    out = b1.tile_raster_fwd_seeded(*seeded)
    torch.cuda.synchronize()
    assert b1.tile_raster_fwd_seeded.launches == before + 1
    plain = b1.tile_raster_fwd_seeded_plain(*seeded)
    assert _close(out[0], plain[0])
    assert torch.equal(out[1], plain[1])
    for seeded_flag in (False, True):
        occ = b1.kernel_occupancy(mode, seeded=seeded_flag, tile_size=ts)
        print(ts, mode, seeded_flag, occ)
        assert occ["local_bytes"] == 0, occ
        assert occ["smem_bytes"] == FWD_SMEM[ts], occ
        assert occ["ctas_per_sm"] == FWD_CTAS[ts], occ


@pytest.mark.gpu
@pytest.mark.parametrize("ts,width,height", [(8, 160, 96), (32, 320, 192)])
@pytest.mark.parametrize("mode,opacity,band", [
    *((m, o, None) for m, o in CASES), (RenderMode.SH3, None, BAND)])
def test_training_kernels_take_tile_8_and_32(ts, width, height, mode,
                                             opacity, band):
    """B2 and B3 at tile sizes 8 and 32, as JAX's XLA executor trains
    there: B2's rgb at 1e-5 * max(1, |plain|), T, nproc and the whole
    ckpt buffer (ceil(P / 128) rows) equal; B3 per table row within
    1e-5 * max|plain row| and bit for bit from run to run; one launch
    each; no spills.  At tile 32 the opaque scene stops early at 320x192
    (at 150x90 no 32x32 tile saturates whole)."""
    dev = _card()
    cfg = RenderConfig(width=width, height=height, mode=mode, tile_size=ts)
    if band is not None:
        band = dict(band, local_rows=cfg.tiles_y // 2)
    args = _train_args(dev, cfg, opacity, band)
    before = (b1.tile_raster_fwd_train.launches, b3.tile_raster_bwd.launches)
    rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    torch.cuda.synchronize()
    assert ckpt.shape[0] == b1.ckpt_rows(ts * ts)
    prgb, ptrans, pckpt, pnproc = b1.tile_raster_fwd_train_plain(*args)
    assert float(prgb.max()) > 0.1
    assert _close(rgb, prgb) and _close(trans, ptrans)
    assert torch.equal(nproc, pnproc) and torch.equal(ckpt, pckpt)
    if opacity is not None:  # the opaque scene stops early somewhere
        s = args[1].to(torch.int64)
        nch = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
        assert bool((nproc.to(torch.int64) < nch).any())

    gen = torch.Generator(device="cpu").manual_seed(3)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen).to(dev)
    g_trans = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    table, starts, counts, row_offset, *rest = args
    bwd_args = (table, starts, counts, nproc, ckpt, row_offset, g_rgb,
                g_trans, trans, *rest)
    g = b3.tile_raster_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert (b1.tile_raster_fwd_train.launches,
            b3.tile_raster_bwd.launches) == (before[0] + 1, before[1] + 1)
    pg = b3.tile_raster_bwd_plain(*bwd_args)
    assert float(pg.abs().max()) > 0
    for c in range(16):
        scale = float(pg[c].abs().max())
        assert float((g[c] - pg[c]).abs().max()) <= 1e-5 * scale, c
    assert torch.equal(g, b3.tile_raster_bwd(*bwd_args))
    occ = b1.kernel_occupancy(mode, train=True, tile_size=ts)
    print(ts, mode, "B2", occ)
    # no spills at 32 either: the 32x2 strips' checkpoint stores cost B2 8
    # spilled bytes there, the 8x8 squares' none
    assert occ["local_bytes"] == 0, occ
    assert occ["smem_bytes"] == FWD_SMEM[ts], occ
    assert occ["ctas_per_sm"] == FWD_CTAS[ts], occ
    occ = b3.kernel_occupancy(mode, False, ts)
    print(ts, mode, "B3", occ)
    assert occ["local_bytes"] == 0, occ
    assert occ["smem_bytes"] == BWD_SMEM[ts], occ


def _multi_window_table(dev, ts, mode, seed):
    """A dense, faint scene at 320x192 whose tiles walk several 256-row
    windows: (binned splats, cfg)."""
    cfg = RenderConfig(width=320, height=192, mode=mode, tile_size=ts)
    scene = random_scene(40000, sh_degree=3, seed=seed, extent=1.2,
                         mean_scale=0.04)
    scene.opacity.fill_(0.1)  # faint: tiles walk their lists to the end
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.1, -0.1, 4.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    return binning.bin_splats(project(scene.to(dev), view,
                                      cam.get_project_matrix(), eye, cfg),
                              cfg), cfg


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 32])
@pytest.mark.parametrize("mode", [RenderMode.SH3, RenderMode.DEPTH])
def test_tile_raster_fwd_multi_window_at_tile_8_and_32(ts, mode):
    """B1 and B2 at tile 8 (128-row blocks staged one at a time) and 32
    (8x8 square bands) on a dense, faint scene whose tiles walk several
    256-row windows: rgb within 1e-5 * max(1, |plain|), T, nproc and the
    whole ckpt buffer equal to the plain version, the same bits from
    launch to launch, one launch each."""
    dev = _card()
    bs, cfg = _multi_window_table(dev, ts, mode, 16)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    before = (b1.tile_raster_fwd.launches, b1.tile_raster_fwd_train.launches)
    rgb, trans = b1.tile_raster_fwd(*args)
    out = b1.tile_raster_fwd_train(*args)
    torch.cuda.synchronize()
    assert (b1.tile_raster_fwd.launches,
            b1.tile_raster_fwd_train.launches) == (before[0] + 1,
                                                   before[1] + 1)
    nproc = out[3]
    assert int(nproc.max()) >= 3, "some tile must walk 3 windows or more"
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    plain = b1.tile_raster_fwd_train_plain(*args)
    assert float(prgb.max()) > 0.05  # DEPTH's grey disparity reaches ~0.1
    assert _close(rgb, prgb) and torch.equal(trans, ptrans)
    assert _close(out[0], plain[0])
    for got, ref in zip(out[1:], plain[1:]):
        assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in
               zip((rgb, trans), b1.tile_raster_fwd(*args)))
    assert all(torch.equal(a, b) for a, b in
               zip(out, b1.tile_raster_fwd_train(*args)))


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 32])
@pytest.mark.parametrize("mode", [RenderMode.SH3, RenderMode.DEPTH])
def test_tile_raster_bwd_multi_window_at_tile_8_and_32(ts, mode):
    """B3 at tile 8 (128-row staged blocks, 8-row sub-blocks) and 32 (two
    band-sum buffers used in turn) on a dense, faint scene whose tiles walk
    several 256-row windows: per table row within 1e-5 * max|plain row|,
    the same bits from launch to launch, one launch."""
    dev = _card()
    bs, cfg = _multi_window_table(dev, ts, mode, 14)
    args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    _, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    assert int(nproc.max()) >= 3, "some tile must walk 3 windows or more"
    gen = torch.Generator(device="cpu").manual_seed(15)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen).to(dev)
    g_trans = torch.randn(tuple(trans.shape), generator=gen).to(dev)
    bwd_args = (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, 0,
                g_rgb, g_trans, trans, cfg)
    before = b3.tile_raster_bwd.launches
    g = b3.tile_raster_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert b3.tile_raster_bwd.launches == before + 1
    pg = b3.tile_raster_bwd_plain(*bwd_args)
    assert float(pg.abs().max()) > 0
    _assert_rows_close(g, pg, 16)
    assert torch.equal(g, b3.tile_raster_bwd(*bwd_args))


@pytest.mark.gpu
def test_band_gradients_at_tile_32_on_card_match_cpu():
    """The band programs of 2 interleaved shards (parallel/sharded_render.py)
    at tile 32 under autograd on the card, B2 and B3 once per band on the
    band tables: their summed gradients against the CPU's within
    1e-4 * max|g|, as test_render_gradient_on_card_matches_cpu."""
    from gaussiansplattingviewer_tpu_torch.models import GaussianData
    from gaussiansplattingviewer_tpu_torch.parallel import sharded_render

    dev = _card()
    cfg = RenderConfig(width=320, height=200, tile_size=32,
                       grad_fold_bf16=False)
    scene = random_scene(20000, sh_degree=3, seed=12, extent=2.0,
                         mean_scale=0.03)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = cam.get_project_matrix()
    n = 2
    rows = sharded_render._rows_per_shard(cfg, n)
    grads = []
    for d in (dev, torch.device("cpu")):
        sc = scene.to(d)
        leaves = [getattr(sc, f).detach().clone().requires_grad_(True)
                  for f in ("xyz", "rot", "scale", "opacity", "sh")]
        before = (b1.tile_raster_fwd_train.launches,
                  b3.tile_raster_bwd.launches)
        for idx in range(n):
            band = sharded_render._render_band(
                GaussianData(*leaves), view, proj, eye, cfg, rows,
                row_stride=n, idx=idx)
            (band * band).sum().backward()
        want = n if d.type == "cuda" else 0
        assert (b1.tile_raster_fwd_train.launches,
                b3.tile_raster_bwd.launches) == (before[0] + want,
                                                 before[1] + want)
        grads.append([p.grad.cpu() for p in leaves])
    for g_card, g_cpu in zip(*grads):
        scale = float(g_cpu.abs().max())
        assert scale > 0
        assert float((g_card - g_cpu).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_cuda_kernels_refuse_other_tile_sizes():
    """The fused training kernels (B4 train, B5) take 16x16 tiles only, the
    JAX fused path's limit (Pallas only, its train kernel's checkpoint
    laid out for 256 pixels): CUDA tensors at tile_size 8 raise and
    nothing runs (no plain fallback, no launch), also through a fused
    render that needs gradients.  Tile 24 raises for every kernel."""
    dev = _card()
    cfg = RenderConfig(width=64, height=48, tile_size=8)
    table = torch.zeros((16, 600), device=dev)
    starts = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32, device=dev)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=dev)
    per_tile = torch.ones((cfg.num_tiles, 64), device=dev)
    kernels = (b1.tile_raster_fwd, b1.tile_raster_fwd_train,
               b1.tile_raster_fwd_seeded, b3.tile_raster_bwd,
               b3.tile_raster_bwd_fused)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="tile_size 16"):
        b1.tile_raster_fwd_seeded(table, starts, counts, per_tile, 0, cfg,
                                  train=True)
    nproc = torch.zeros_like(counts)
    ckpt = torch.zeros((1, 600), device=dev)
    g_rgb = torch.zeros((cfg.num_tiles, 64, 3), device=dev)
    with pytest.raises(ValueError, match="tile_size 16"):
        b3.tile_raster_bwd_fused(table, starts, counts, nproc, nproc, ckpt, 0,
                                 g_rgb, per_tile, per_tile, per_tile,
                                 per_tile, 1024, cfg)
    c24 = cfg.with_(tile_size=24, width=48, height=48)
    t24 = (table, starts[:5], counts[:4])
    per24 = torch.ones((4, 576), device=dev)
    g24 = torch.zeros((4, 576, 3), device=dev)
    ck24 = torch.zeros((5, 600), device=dev)
    for call in (
            lambda: b1.tile_raster_fwd(*t24, 0, c24),
            lambda: b1.tile_raster_fwd_train(*t24, 0, c24),
            lambda: b1.tile_raster_fwd_seeded(*t24, per24, 0, c24),
            lambda: b3.tile_raster_bwd(*t24, nproc[:4], ck24, 0, g24, per24,
                                       per24, c24)):
        with pytest.raises(ValueError, match="tile_size"):
            call()
    assert before == [k.launches for k in kernels]
    scene = random_scene(500, sh_degree=0, seed=3, extent=2.0,
                         mean_scale=0.05).to(dev)
    scene.xyz.requires_grad_(True)
    view = tf.look_at([0, 0, 5.0], [0, 0, 0], [0, -1, 0])
    cam = Camera(h=cfg.height, w=cfg.width)
    with pytest.raises(ValueError, match="tile_size 16"):
        render(scene, view, cam.get_project_matrix(),
               np.array([0, 0, 5.0], np.float32),
               cfg.with_(fused_grad=True, prefix_rows=8,
                         residual_budget_rows=1 << 16), device=dev)
    assert before == [k.launches for k in kernels]


def _classic_grads(dev, cfg, scene, view, proj, eye):
    sc = scene.to(dev)
    leaves = [getattr(sc, f).detach().clone().requires_grad_(True)
              for f in ("xyz", "rot", "scale", "opacity", "sh")]
    from gaussiansplattingviewer_tpu_torch.models import GaussianData

    img = render(GaussianData(*leaves), view, proj, eye, cfg, device=dev)
    (img * img).sum().backward()
    return [p.grad for p in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("fold_bf16", [False, True])
def test_classic_backward_repeats_bit_for_bit(fold_bf16):
    """The classic fold (a stable sort by splat id and one segment sum per
    splat) has no atomics: two backwards give the same bits."""
    dev = _card()
    cfg = RenderConfig(width=320, height=192, grad_fold_bf16=fold_bf16)
    scene = random_scene(20000, sh_degree=3, seed=11, extent=2.0,
                         mean_scale=0.03)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    args = (dev, cfg, scene, view, cam.get_project_matrix(), eye)
    first = _classic_grads(*args)
    for a, b in zip(first, _classic_grads(*args)):
        assert float(a.abs().max()) > 0
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("interleaved", [False, True])
def test_band_programs_on_card_match_render(interleaved):
    """Each of 4 shards' band programs (parallel/sharded_render.py), run by
    index in one process on the card: the bands reassemble render()'s
    image at 1e-5 * max(1, |ref|), one B1 launch each."""
    from gaussiansplattingviewer_tpu_torch.parallel import sharded_render

    dev = _card()
    cfg = RenderConfig(width=320, height=200)
    scene = random_scene(20000, sh_degree=3, seed=12, extent=2.0,
                         mean_scale=0.03).to(dev)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = cam.get_project_matrix()
    with torch.no_grad():
        ref = render(scene, view, proj, eye, cfg, device=dev)
        out = torch.zeros_like(ref)
        n = 4
        rows = sharded_render._rows_per_shard(cfg, n)
        before = b1.tile_raster_fwd.launches
        for idx in range(n):
            band = sharded_render._render_band(
                scene, view, proj, eye, cfg, rows,
                row_stride=n if interleaved else 1, idx=idx)
            y = sharded_render.band_pixel_rows(cfg, n, idx, interleaved)
            live = y < cfg.height
            out[y[live].to(dev)] = band[live.to(dev), : cfg.width]
        assert b1.tile_raster_fwd.launches == before + n
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


def _projection_case(dev, mode, stored_degree, n=4000, seed=21):
    """A scene for P1/P2 against the plain ``_project`` on the card, with
    padding splats (opacity 0 at the origin, as the benchmark pads),
    splats behind the camera and splats outside the 1.3-ndc cull; splats
    within 1e-5 of a cull threshold (|ndc| at the limit, w at 1e-8) are
    taken out, so that ``valid`` compares exactly."""
    from gaussiansplattingviewer_tpu_torch.models import GaussianData

    cfg = RenderConfig(width=320, height=192, mode=mode)
    s = random_scene(n, sh_degree=stored_degree, seed=seed, extent=2.0,
                     mean_scale=0.05)
    xyz, opacity = s.xyz.clone(), s.opacity.clone()
    # behind the eye (z = 5), clear of its plane: there w is a difference
    # of nearly equal terms, whose last bits depend on the sum's order
    xyz[: n // 10, 2] = 7.0 + 0.5 * xyz[: n // 10, 2]
    xyz[n // 10: n // 5, 0] *= 6.0  # many outside the cull
    pad = slice(n - n // 10, n)
    xyz[pad] = 0.0
    opacity[pad] = 0.0
    rot, scale = s.rot.clone(), s.scale.clone()
    rot[pad] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    scale[pad] = 1e-9
    sh = s.sh.clone()
    sh[pad] = 0.0
    scene = GaussianData(xyz, rot, scale, opacity, sh).to(dev)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 5.0], np.float32)
    camera = [torch.as_tensor(m, dtype=torch.float32, device=dev)
              for m in (tf.look_at(eye, [0, 0, 0], [0, -1, 0]),
                        cam.get_project_matrix(), eye)]
    # the margins, in float64 from the plain path's own view and clip
    v, p = camera[0].double(), camera[1].double()
    mv = scene.xyz.double() @ v[:3, :3].T + v[:3, 3]
    clip = torch.cat([mv, torch.ones_like(mv[:, :1])], 1) @ p.T
    ndc = clip[:, :3] / clip[:, 3:]
    # (det needs no margin: the +0.3 low-pass keeps it above 0.09)
    far = ((ndc.abs() - cfg.ndc_cull_limit).abs().min(1).values > 1e-5) \
        & ((clip[:, 3] - 1e-8).abs() > 1e-5)
    keep = far.nonzero()[:, 0]
    scene = GaussianData(*(getattr(scene, f)[keep].contiguous() for f in
                           ("xyz", "rot", "scale", "opacity", "sh")))
    return cfg, scene, camera


_PROJ_OUT = ("mean2d", "depth", "conic", "radius", "color")


@pytest.mark.gpu
@pytest.mark.parametrize("stored_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", list(RenderMode))
def test_project_kernel_matches_plain(mode, stored_degree):
    """P1 against the plain ``_project`` on the card, every mode and SH
    stored at degrees 0-3: floats within 1e-5 of each field's largest
    magnitude (the view transform's and the SH sums' order differs),
    ``valid`` exactly; the scene holds padding, splats behind the camera
    and splats outside the cull."""
    from gaussiansplattingviewer_tpu_torch.ops.projection import _project
    from gaussiansplattingviewer_tpu_torch.ops.sh import used_degree

    dev = _card()
    cfg, scene, camera = _projection_case(dev, mode, stored_degree)
    want = _project(scene, *camera, cfg)
    got = project(scene, *camera, cfg)
    torch.cuda.synchronize()
    assert 0 < int(want.valid.sum()) < len(scene) * 0.8
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.opacity, want.opacity)
    for f in _PROJ_OUT:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        tol = 1e-5 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol, (mode, f)
    assert used_degree(int(mode), scene.sh.shape[1]) == min(
        max(int(mode), 0), stored_degree)


def _projection_grads(scene, camera, cfg, cots, plain):
    from gaussiansplattingviewer_tpu_torch.models import GaussianData
    from gaussiansplattingviewer_tpu_torch.ops.projection import _project

    leaves = [getattr(scene, f).clone().requires_grad_(True)
              for f in ("xyz", "rot", "scale", "opacity", "sh")]
    fn = _project if plain else project
    out = fn(GaussianData(*leaves), *camera, cfg)
    sum((getattr(out, f) * c).sum()
        for f, c in zip((*_PROJ_OUT, "opacity"), cots)).backward()
    return [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(RenderMode))
def test_project_kernel_gradients_match_plain(mode):
    """P2 under random cotangents on all five float outputs (and on
    opacity, whose gradient is the same identity on both) against autograd
    of the plain path on the card, within 1e-4 of each leaf's largest
    gradient; DEPTH mode gives sh none on both."""
    dev = _card()
    cfg, scene, camera = _projection_case(dev, mode, 3)
    gen = torch.Generator(device=dev).manual_seed(5)
    ref = project(scene, *camera, cfg)
    cots = [torch.randn(getattr(ref, f).shape, generator=gen, device=dev)
            for f in (*_PROJ_OUT, "opacity")]
    want = _projection_grads(scene, camera, cfg, cots, plain=True)
    got = _projection_grads(scene, camera, cfg, cots, plain=False)
    for name, a, b in zip(("xyz", "rot", "scale", "opacity", "sh"), got,
                          want):
        if b is None:
            assert a is None and name == "sh" and mode == RenderMode.DEPTH
            continue
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= 1e-4 * scale, (mode, name)


@pytest.mark.gpu
def test_project_kernel_counts_and_repeats_bit_for_bit():
    """One P1 launch and ``project.kernel_splats`` += N per call, one P2
    per backward; the same scene gives the same gradient bits twice (one
    thread per splat, no atomics)."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import projection as kp
    from gaussiansplattingviewer_tpu_torch.utils import profiling

    dev = _card()
    cfg, scene, camera = _projection_case(dev, RenderMode.SH3, 3)
    n = len(scene)
    cots = [torch.ones(s, device=dev)
            for s in ((n, 2), (n,), (n, 3), (n, 2), (n, 3), (n,))]
    fwd, bwd = kp.project_fwd.launches, kp.project_bwd.launches
    with profiling.collect() as rec:
        first = _projection_grads(scene, camera, cfg, cots, plain=False)
    assert (kp.project_fwd.launches, kp.project_bwd.launches) == (fwd + 1,
                                                                  bwd + 1)
    assert rec.counts["project.kernel_splats"] == len(scene)
    second = _projection_grads(scene, camera, cfg, cots, plain=False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_project_kernel_reads_strided_cotangents():
    """P2 takes cotangents of any strides, as autograd hands them over
    (the packed table's gradient columns, an expanded scalar): the same
    bits as from contiguous copies."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import projection as kp

    dev = _card()
    cfg, scene, camera = _projection_case(dev, RenderMode.SH3, 3)
    n = len(scene)
    rows = torch.randn((n, 16), device=dev)
    strided = [rows[:, 0:2], rows[:, 11], rows[:, 2:5], rows[:, 9:11],
               torch.ones((1, 1), device=dev).expand(n, 3)]
    leaves = [getattr(scene, f) for f in ("xyz", "rot", "scale", "opacity",
                                          "sh")]
    got = kp.project_bwd(*leaves, *camera, cfg, strided)
    want = kp.project_bwd(*leaves, *camera, cfg,
                          [g.contiguous() for g in strided])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_project_kernel_geometry_is_the_plain_bits():
    """At a garden-like size and oblique poses, P1's mean2d, depth, conic,
    radius and valid equal the plain ``_project``'s on the card bit for
    bit: its view and clip transforms round as the card's GEMM does.  A
    one-ulp depth moves a splat across a depth-key bucket of binning and
    reorders it among the splats it overlaps."""
    from gaussiansplattingviewer_tpu_torch.ops.projection import _project

    dev = _card()
    cfg = RenderConfig(width=1920, height=1080)
    scene = random_scene(1 << 20, sh_degree=3, seed=31, extent=4.0,
                         mean_scale=0.015).to(dev)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    with torch.no_grad():
        for a in (0.3, 1.7, 4.0):
            eye = np.array([9.0 * np.sin(a), 1.5, 9.0 * np.cos(a)],
                           np.float32)
            camera = [torch.as_tensor(m, dtype=torch.float32, device=dev)
                      for m in (tf.look_at(eye, [0.2, -0.1, 0.3],
                                           [0, -1, 0]),
                                cam.get_project_matrix(), eye)]
            got = project(scene, *camera, cfg)
            want = _project(scene, *camera, cfg)
            for f in ("mean2d", "depth", "conic", "radius", "valid"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (a, f)
