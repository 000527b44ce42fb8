"""PyTorch port: two repairs held to the JAX package.

  * Any tile size on the plain path: renders at tile_size 8 and 32 on the
    CPU against JAX's ``tile`` backend at 1e-5, forward and gradients
    (grad_fold_bf16 off, 1e-5 * max|g|).
  * The classic gradient fold (``binning.fold_table_grad``: a stable sort
    by splat id and one segment sum per splat) against JAX's fold
    (``_gather_table_rows``'s VJP) on the same table cotangent, with and
    without the bf16 rounding, within 1e-5 * max|g| per field, and
    against an f64 per-splat sum.  That it repeats bit for bit on the card
    is tests/test_torch_kernels_gpu.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.projection import project as jax_project
from gaussiansplattingviewer_tpu.ops.render import render as jax_render
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.render import render
from torch_port_util import both_splats, port_cfg, port_scene, splats_numpy

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
GRAD_SPLAT_FIELDS = ("mean2d", "conic", "color", "opacity")


def _setup(cfg):
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.4, -0.3, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    return view, cam.get_project_matrix(), eye


@pytest.mark.parametrize("ts,width,height", [(8, 160, 96), (32, 150, 90)])
def test_render_any_tile_size_matches_jax(ts, width, height):
    cfg = JaxConfig(width=width, height=height, tile_size=ts,
                    grad_fold_bf16=False)
    scene = random_scene(2000, sh_degree=3, seed=1, extent=2.5,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg)
    weights = np.random.default_rng(ts).normal(
        size=(height, width, 3)).astype(np.float32)

    def jloss(sc):
        return jnp.sum(jax_render(sc, view, proj, eye, cfg, backend="tile")
                       * weights)

    sd = scene.to_device()
    want = np.asarray(jax_render(sd, view, proj, eye, cfg, backend="tile"))
    g_jax = jax.grad(jloss)(sd)

    sc = port_scene(scene)
    for f in FIELDS:
        getattr(sc, f).requires_grad_(True)
    img = render(sc, view, proj, eye, port_cfg(cfg), device="cpu")
    assert img.shape == (height, width, 3)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(img.detach().numpy(), want, atol=1e-5)
    (img * torch.from_numpy(weights)).sum().backward()
    for f in FIELDS:
        a = np.asarray(getattr(g_jax, f))
        scale = np.abs(a).max()
        assert scale > 0, f
        np.testing.assert_allclose(getattr(sc, f).grad.numpy(), a,
                                   atol=1e-5 * scale, err_msg=f)


def _binned_both(cfg, seed):
    scene = random_scene(2000, sh_degree=3, seed=seed, extent=2.5,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg)
    arrays = splats_numpy(jax_project(scene.to_device(), view, proj, eye,
                                      cfg))
    return both_splats(arrays)


@pytest.mark.parametrize("fold_bf16", [False, True])
def test_fold_matches_jax(fold_bf16):
    cfg = JaxConfig(width=160, height=96, grad_fold_bf16=fold_bf16)
    j_s, p_s = _binned_both(cfg, seed=3)
    want = jax_bin(j_s, cfg)
    assert int(want.overflow) == 0 and int(want.truncated) == 0
    total = int(want.num_duplicates)
    assert total > 1000
    g = np.random.default_rng(4).normal(size=(16, total)).astype(np.float32)

    def jtable(*fields):
        s = j_s.__class__(**dict(zip(GRAD_SPLAT_FIELDS, fields)),
                          depth=j_s.depth, radius=j_s.radius,
                          valid=j_s.valid)
        return jax_bin(s, cfg).table

    table, vjp = jax.vjp(jtable, *(getattr(j_s, f)
                                   for f in GRAD_SPLAT_FIELDS))
    g_full = np.zeros(table.shape, np.float32)
    g_full[:, :total] = g
    g_jax = vjp(jnp.asarray(g_full))

    for f in GRAD_SPLAT_FIELDS:
        getattr(p_s, f).requires_grad_(True)
    got = binning.bin_splats(p_s, port_cfg(cfg))
    assert int(got.num_duplicates) == total
    g_port = torch.zeros(got.table.shape)
    g_port[:, :total] = torch.from_numpy(g)
    got.table.backward(g_port)
    for f, gj in zip(GRAD_SPLAT_FIELDS, g_jax):
        a = np.asarray(gj)
        scale = np.abs(a).max()
        assert scale > 0, f
        np.testing.assert_allclose(getattr(p_s, f).grad.numpy(), a,
                                   atol=1e-5 * scale, err_msg=f)


@pytest.mark.parametrize("fold_bf16", [False, True])
@pytest.mark.parametrize("cap", [3000, 2500])
def test_fold_sums_each_splats_rows(fold_bf16, cap):
    """Each splat gets the sum of its own table columns below ``cap``
    (rounded to bf16 first with ``fold_bf16``) within f32 rounding of an
    f64 sum; truncated columns, splats with no column and the columns past
    GRAD_WIDTH give exact zeros."""
    rng = np.random.default_rng(7)
    n, m = 50, 3000
    sid = torch.from_numpy(rng.integers(0, n - 5, m))  # 5 splats unused
    g = torch.from_numpy(rng.normal(size=(16, m + 512)).astype(
        np.float32) * 10.0 ** rng.integers(-3, 3, (16, m + 512)))
    # the duplicates in splat-major order: their table columns and bounds
    pos = torch.argsort(sid, stable=True)
    offsets = torch.searchsorted(sid[pos], torch.arange(n + 1))
    got = binning.fold_table_grad(g, pos, offsets, cap, fold_bf16)
    rows = g[: binning.GRAD_WIDTH, :cap].T
    if fold_bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    want = torch.zeros((n, binning.GRAD_WIDTH), dtype=torch.float64)
    want.index_add_(0, sid[:cap], rows.double())
    mag = torch.zeros_like(want).index_add_(0, sid[:cap],
                                            rows.double().abs())
    assert bool(((got[:, : binning.GRAD_WIDTH].double() - want).abs()
                 <= 1e-6 * mag).all())
    assert torch.equal(got[n - 5:], torch.zeros((5, binning.TABLE_WIDTH)))
    assert torch.equal(got[:, binning.GRAD_WIDTH:],
                       torch.zeros((n, binning.TABLE_WIDTH
                                    - binning.GRAD_WIDTH)))


@pytest.mark.parametrize("ts", [8, 32])
def test_warp_cull_mirror_any_tile_size(ts):
    """The plain versions' mirror of the kernels' warp cull at other tile
    sizes (bands of ``band_rows(ts)`` tile rows) skips only fragments of
    alpha 0: forward and backward give the same bits with and without
    it."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as kb,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as kf,
    )

    cfg = port_cfg(JaxConfig(width=160, height=96, tile_size=ts))
    _, p_s = _binned_both(JaxConfig(width=160, height=96, tile_size=ts),
                          seed=5)
    bs = binning.bin_splats(p_s, cfg)
    px, py = kf.tile_pixel_grid(cfg, cfg.tiles_y)
    kept = kf.warp_cull_plain(bs.table[:11, None, :4],
                              torch.ones((1, 4), dtype=torch.bool), px[:1],
                              py[:1])
    assert kept.shape == (1, 4, ts // kf.band_rows(ts))
    out = {}
    for cull in (False, True):
        ckpt = torch.zeros((kf.ckpt_rows(ts * ts), bs.table.shape[1]))
        rgb, trans, nproc = kf.blend_tiles_plain(
            bs.table, bs.tile_starts[:-1], bs.tile_counts, px, py, cfg,
            ckpt=ckpt, cull=cull)
        g_rgb = torch.ones_like(rgb)
        g_t = torch.full_like(trans, 0.5)
        g = kb.blend_tiles_bwd_plain(
            bs.table, bs.tile_starts[:-1], bs.tile_counts, nproc, ckpt, px,
            py, g_rgb, g_t, trans, cfg, cull=cull)
        out[cull] = (rgb, trans, nproc, ckpt, g)
    assert float(out[False][0].max()) > 0.1
    assert float(out[False][4].abs().max()) > 0
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
