"""PyTorch port: the tile-row-sharded render's band program
(parallel/sharded_render.py) against the JAX package's, in one process.

  * ``_render_band`` by concrete shard index (contiguous, interleaved and
    pre-culled bands, 2 and 4 shards) against JAX ``_render_band(idx=...)``
    at 1e-5, as tests/test_sharding.py holds JAX's to its single-chip
    render;
  * ``band_precull_mask`` equal to JAX's, bit for bit;
  * ``_exchange_parts`` rows, valid and dropped equal to JAX's for 2, 4
    and 8 shards (8 takes the pool), its VJP within 1e-6;
  * the band gradients of sum(img * w), summed over 4 bands (2 at tile
    32), against JAX ``make_sharded_render_fn`` on conftest's CPU mesh at
    1e-5 * max|g| (grad_fold_bf16 off)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.parallel import (
    make_mesh,
    make_sharded_render_fn,
    replicate_scene,
)
from gaussiansplattingviewer_tpu.parallel import sharded_render as jsr
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.parallel import sharded_render as psr
from torch_port_util import (
    both_splats,
    port_cfg,
    port_scene,
    synthetic_splats,
)

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
FLOAT_FIELDS = ("mean2d", "depth", "conic", "radius", "color", "opacity")
BAND_MODES = {"contiguous": {}, "interleaved": "stride",
              "precull": dict(precull_budget_factor=2.5)}


def _setup(cfg, scene):
    cam = Camera(h=cfg.height, w=cfg.width)
    view = tf.look_at([0, 0, 3], [0, 0, 0], [0, -1, 0])
    return view, cam.get_project_matrix(), np.array([0, 0, 3.0], np.float32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", list(BAND_MODES))
def test_render_band_matches_jax(n, mode):
    cfg = JaxConfig(width=160, height=96)
    scene = random_scene(800, sh_degree=1, seed=4, extent=2.0,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg, scene)
    kw = dict(row_stride=n) if BAND_MODES[mode] == "stride" \
        else BAND_MODES[mode]
    rows = jsr._rows_per_shard(cfg, n)
    sd, ps, pc = scene.to_device(), port_scene(scene), port_cfg(cfg)
    for idx in range(n):
        want = np.asarray(jsr._render_band(
            sd, jnp.asarray(view), jnp.asarray(proj), jnp.asarray(eye),
            cfg=cfg, rows=rows, use_pallas=False, idx=jnp.int32(idx), **kw))
        got, aux = psr._render_band(ps, view, proj, eye, pc, rows, idx=idx,
                                    return_aux=True, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=f"{mode} n={n} idx={idx}")
        assert int(aux["dropped"]) == int(aux["truncated"]) == 0


@pytest.mark.parametrize("mode", [JaxMode.SH3, JaxMode.DEPTH])
@pytest.mark.parametrize("stride", [1, 3])
def test_band_precull_mask_bit_equal(mode, stride):
    cfg = JaxConfig(width=160, height=160, mode=mode, scale_modifier=1.3)
    scene = random_scene(3000, sh_degree=3, seed=9, extent=3.0,
                         mean_scale=0.08)
    # some splats behind the camera, some at zero opacity
    xyz = np.asarray(scene.xyz).copy()
    xyz[:200, 2] += 4.0
    scene.xyz = xyz
    op = np.asarray(scene.opacity).copy()
    op[200:260] = 0.0
    scene.opacity = op
    view, proj, _ = _setup(cfg, scene)
    ps = port_scene(scene)
    for lo, hi in ((0, 3), (4, 8), (7, 10)):
        want = np.asarray(jsr.band_precull_mask(
            scene.to_device(), jnp.asarray(view), jnp.asarray(proj), cfg,
            lo, hi, stride))
        got = psr.band_precull_mask(ps, view, proj, port_cfg(cfg), lo, hi,
                                    stride).numpy()
        np.testing.assert_array_equal(got, want, f"rows {lo}..{hi}")
        assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("n_shards,stride,factor", [
    (2, 1, 3.0), (2, 2, 0.05), (4, 1, 3.0), (4, 4, 3.0), (8, 1, 3.0),
    (8, 8, 3.0)])
def test_exchange_parts_matches_jax(n_shards, stride, factor):
    cfg = JaxConfig(width=160, height=96)
    arrays = synthetic_splats(6000, 160, 96, seed=n_shards + stride,
                              scale=(1.0, 14.0))
    arrays["valid"][::11] = False
    if factor < 1.0:  # crowd the top rows: a segment passes its budget
        arrays["mean2d"][:5000, 1] = np.random.default_rng(1).uniform(
            0, 20, 5000)
    j_s, p_s = both_splats(arrays)
    rows = jsr._rows_per_shard(cfg, n_shards)
    j_rows, j_valid, j_drop = jsr._exchange_parts(j_s, cfg, rows, n_shards,
                                                  factor, stride)
    for f in FLOAT_FIELDS:
        getattr(p_s, f).requires_grad_(True)
    p_rows, p_valid, p_drop = psr._exchange_parts(
        p_s, port_cfg(cfg), rows, n_shards, factor, stride)
    np.testing.assert_array_equal(p_rows.detach().numpy(),
                                  np.asarray(j_rows))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(j_valid))
    assert int(p_drop) == int(j_drop)
    if factor < 1.0:
        assert int(p_drop) > 0

    g = np.random.default_rng(2).normal(
        size=np.asarray(j_rows).shape).astype(np.float32)

    def jrows(*fields):
        s = j_s.__class__(**dict(zip(FLOAT_FIELDS, fields)),
                          valid=j_s.valid)
        return jsr._exchange_parts(s, cfg, rows, n_shards, factor,
                                   stride)[0]

    _, vjp = jax.vjp(jrows, *(getattr(j_s, f) for f in FLOAT_FIELDS))
    g_jax = vjp(jnp.asarray(g))
    p_rows.backward(torch.from_numpy(g))
    for f, gj in zip(FLOAT_FIELDS, g_jax):
        np.testing.assert_allclose(getattr(p_s, f).grad.numpy(),
                                   np.asarray(gj), atol=1e-6, err_msg=f)


def _band_grads_vs_jax(cfg, n, interleaved):
    """The band gradients of sum(img * w) over n shards, summed, against
    JAX make_sharded_render_fn(use_pallas=False) at 1e-5 * max|g|."""
    scene = random_scene(300, sh_degree=0, seed=6, extent=2.0,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg, scene)
    weights = np.random.default_rng(5).normal(
        size=(cfg.height, cfg.width, 3)).astype(np.float32)
    mesh = make_mesh(n)
    fn = make_sharded_render_fn(mesh, cfg, use_pallas=False,
                                interleaved=interleaved)
    g_jax = jax.grad(lambda sc: jnp.sum(
        fn(sc, jnp.asarray(view), jnp.asarray(proj), jnp.asarray(eye))
        * weights))(replicate_scene(scene.to_device(), mesh))

    pc = port_cfg(cfg)
    ps = port_scene(scene)
    for f in FIELDS:
        getattr(ps, f).requires_grad_(True)
    rows = psr._rows_per_shard(pc, n)
    w = torch.from_numpy(weights)
    for idx in range(n):
        band = psr._render_band(ps, view, proj, eye, pc, rows,
                                row_stride=n if interleaved else 1, idx=idx)
        y = psr.band_pixel_rows(pc, n, idx, interleaved)
        live = y < pc.height
        (band[live, : pc.width] * w[y[live]]).sum().backward()
    for f in FIELDS:
        want = np.asarray(getattr(g_jax, f))
        scale = np.abs(want).max()
        assert scale > 0, f
        np.testing.assert_allclose(getattr(ps, f).grad.numpy(), want,
                                   atol=1e-5 * scale, err_msg=f)


@pytest.mark.parametrize("interleaved", [False, True])
def test_band_grads_sum_to_jax_sharded(interleaved):
    _band_grads_vs_jax(JaxConfig(width=96, height=96, grad_fold_bf16=False),
                       4, interleaved)


@pytest.mark.parametrize("interleaved", [False, True])
def test_band_grads_sum_to_jax_sharded_at_tile_32(interleaved):
    """B2 and B3's plain versions on band tables at tile 32 (3 tile rows
    over 2 shards, one band padded), against JAX's sharded XLA executor."""
    _band_grads_vs_jax(JaxConfig(width=150, height=90, tile_size=32,
                                 grad_fold_bf16=False), 2, interleaved)
