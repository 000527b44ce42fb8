"""PyTorch port: classic training at tile sizes 8 and 32, held to the JAX
package's XLA executor, which trains at any tile size.

  * The table cotangent of the port's classic blend (``ops/blend.py``'s
    autograd Function: plain B2 forward, plain B3 backward) against
    ``jax.vjp`` of JAX ``blend_tiles(cfg, use_pallas=False, ...)`` on the
    same JAX ``bin_splats`` table and the same image cotangents, at tile 8
    (160x96) and tile 32 (150x90): one case per fragment family (SH3,
    BILLBOARD, FLAT_BALL, GAUSSIAN_BALL) and a crowded SH3 scene whose
    tiles span several 256-row windows, so that B3 reads B2's checkpoints
    (at tile 8 the half-empty checkpoint row).  Per table row within
    1e-5 * max|g[row]|, rows JAX leaves at zero exactly zero; the forward
    within 1e-5.  The SH3 scenes never stop early: the XLA executor tests
    its early stop every 16 rows, the kernels every 256.
That JAX's tile backend trains at 8 and 32 is
tests/test_torch_tile_sizes.py's, the sharded band gradients at tile 32
tests/test_torch_sharding.py's, the kernels themselves at 8 and 32
tests/test_torch_kernels_gpu.py's (they need the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.blend import blend_tiles as jax_blend
from gaussiansplattingviewer_tpu_torch.ops import blend
from torch_port_util import both_splats, port_cfg, synthetic_splats

SIZES = [(8, 160, 96), (32, 150, 90)]
CASES = [(JaxMode.SH3, "plain"), (JaxMode.BILLBOARD, "plain"),
         (JaxMode.FLAT_BALL, "plain"), (JaxMode.GAUSSIAN_BALL, "plain"),
         (JaxMode.SH3, "crowd")]


def _scene(kind, width, height):
    if kind == "crowd":
        # faint splats crowding the centre: lists of several windows and
        # no saturation
        crowd = synthetic_splats(1500, width, height, seed=6,
                                 centre=(width / 2, height / 2),
                                 spread=(10, 8), scale=(0.6, 1.5),
                                 opacity=(0.01, 0.03))
        others = synthetic_splats(120, width, height, seed=7,
                                  scale=(1.0, 2.0))
        return {f: np.concatenate([others[f], crowd[f]]) for f in crowd}
    return synthetic_splats(700, width, height, seed=3)


def _spy(monkeypatch, name, calls):
    orig = getattr(blend, name)

    def run(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(blend, name, run)


@pytest.mark.parametrize("mode,kind", CASES)
@pytest.mark.parametrize("ts,width,height", SIZES)
def test_classic_blend_vjp_matches_jax_xla(ts, width, height, mode, kind,
                                           monkeypatch):
    # a table budget that keeps every duplicate (tile 8 lists ~8 per splat)
    cfg = JaxConfig(width=width, height=height, tile_size=ts, mode=mode,
                    grad_fold_bf16=False, table_budget_rows=1 << 16)
    jax_s, _ = both_splats(_scene(kind, width, height))
    binned = jax_bin(jax_s, cfg)
    assert int(binned.truncated) == 0 and int(binned.overflow) == 0
    p = ts * ts
    rng = np.random.default_rng(ts)
    g_rgb = rng.normal(size=(cfg.num_tiles, p, 3)).astype(np.float32)
    g_t = rng.normal(size=(cfg.num_tiles, p)).astype(np.float32)

    (j_rgb, j_t), vjp = jax.vjp(
        lambda tb: jax_blend(cfg, False, cfg.tiles_y, 1, tb,
                             binned.tile_starts, binned.tile_counts,
                             jnp.int32(0)), binned.table)
    (want,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_t)))
    want = np.asarray(want)

    calls = []
    _spy(monkeypatch, "tile_raster_fwd_train", calls)
    _spy(monkeypatch, "tile_raster_bwd", calls)
    table = torch.from_numpy(np.array(binned.table)).requires_grad_(True)
    starts = torch.from_numpy(np.array(binned.tile_starts))
    counts = torch.from_numpy(np.array(binned.tile_counts))
    pc = port_cfg(cfg)
    rgb, trans = blend.blend_tiles(pc, pc.tiles_y, 1, table, starts, counts)
    got, = torch.autograd.grad((rgb, trans), table,
                               (torch.from_numpy(g_rgb),
                                torch.from_numpy(g_t)))
    assert calls == ["tile_raster_fwd_train", "tile_raster_bwd"]
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(trans.detach().numpy(), np.asarray(j_t),
                               atol=1e-5, rtol=0)
    assert float(np.asarray(j_rgb).max()) > 0.1

    # no gaussian tile stops early (in billboard and ball modes a stopped
    # tile's T is exactly 0, so the rows behind it have zero terms in both
    # executors); the crowd's lists span several windows
    s = np.asarray(binned.tile_starts).astype(np.int64)
    if mode == JaxMode.SH3:
        assert float(np.asarray(j_t).max(axis=1).min()) \
            > cfg.early_stop_transmittance
    if kind == "crowd":
        base = s[:-1] // 128 * 128
        assert int((s[1:] - base).max()) > 256

    got = got.numpy()
    used = 0
    for c in range(16):
        scale = np.abs(want[c]).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got[c], 0.0, err_msg=f"row {c}")
            continue
        used += 1
        np.testing.assert_allclose(got[c], want[c], atol=1e-5 * scale,
                                   rtol=0, err_msg=f"row {c}")
    assert used == (9 if mode == JaxMode.SH3 else 3)


def test_early_stop_at_tile_8_against_jax(monkeypatch):
    """The tile-wide early stop at tile 8 on an opaque scene whose tiles
    saturate.  The port tests the stop once per 256-row window, as JAX's
    Pallas kernel does; JAX's XLA executor (its only training route at 8)
    every 16 rows, so where a tile saturates the two JAX executors differ
    by up to early_stop_transmittance, and so does the port.

      * early_stop_transmittance = 0: the port's table cotangent against
        jax.vjp of the XLA executor per table row within 1e-5 * max|g[row]|
        (grad_fold_bf16 off);
      * the stop on: the port's forward against JAX's Pallas kernel
        (interpret mode) within 1e-6, and against the XLA executor within
        early_stop_transmittance, with a tile stopping before its list
        ends."""
    width, height, ts = 96, 64, 8
    scene = synthetic_splats(3000, width, height, seed=33, scale=(2.0, 6.0),
                             opacity=(0.95, 0.99))
    jax_s, _ = both_splats(scene)
    p = ts * ts
    stop_cfg = JaxConfig(width=width, height=height, tile_size=ts,
                         grad_fold_bf16=False, table_budget_rows=1 << 16)
    binned = jax_bin(jax_s, stop_cfg)
    assert int(binned.truncated) == 0 and int(binned.overflow) == 0
    table = torch.from_numpy(np.array(binned.table))
    starts = torch.from_numpy(np.array(binned.tile_starts))
    counts = torch.from_numpy(np.array(binned.tile_counts))
    jargs = (binned.table, binned.tile_starts, binned.tile_counts,
             jnp.int32(0))

    # the stop on: forwards
    pc = port_cfg(stop_cfg)
    with torch.no_grad():
        rgb, trans = blend.blend_tiles(pc, pc.tiles_y, 1, table, starts,
                                       counts)
    _, _, _, nproc = blend.tile_raster_fwd_train(table, starts, counts, 0,
                                                 pc)
    s = starts.to(torch.int64)
    windows = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
    assert bool((nproc.to(torch.int64) < windows).any())
    got = (rgb.numpy(), trans.numpy())
    assert float(got[0].max()) > 0.1
    pallas = jax_blend(stop_cfg, True, stop_cfg.tiles_y, 1, *jargs)
    xla = jax_blend(stop_cfg, False, stop_cfg.tiles_y, 1, *jargs)
    for g, w_pallas, w_xla in zip(got, pallas, xla):
        np.testing.assert_allclose(g, np.asarray(w_pallas), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(
            g, np.asarray(w_xla),
            atol=stop_cfg.early_stop_transmittance, rtol=0)

    # the stop off: gradients
    cfg = JaxConfig(width=width, height=height, tile_size=ts,
                    grad_fold_bf16=False, table_budget_rows=1 << 16,
                    early_stop_transmittance=0.0)
    rng = np.random.default_rng(34)
    g_rgb = rng.normal(size=(cfg.num_tiles, p, 3)).astype(np.float32)
    g_t = rng.normal(size=(cfg.num_tiles, p)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda tb: jax_blend(cfg, False, cfg.tiles_y, 1, tb,
                             *jargs[1:]), binned.table)
    (want,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_t)))
    want = np.asarray(want)
    calls = []
    _spy(monkeypatch, "tile_raster_fwd_train", calls)
    _spy(monkeypatch, "tile_raster_bwd", calls)
    leaf = table.clone().requires_grad_(True)
    pc = port_cfg(cfg)
    rgb, trans = blend.blend_tiles(pc, pc.tiles_y, 1, leaf, starts, counts)
    got, = torch.autograd.grad((rgb, trans), leaf,
                               (torch.from_numpy(g_rgb),
                                torch.from_numpy(g_t)))
    assert calls == ["tile_raster_fwd_train", "tile_raster_bwd"]
    got = got.numpy()
    used = 0
    for c in range(16):
        scale = np.abs(want[c]).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got[c], 0.0, err_msg=f"row {c}")
            continue
        used += 1
        np.testing.assert_allclose(got[c], want[c], atol=1e-5 * scale,
                                   rtol=0, err_msg=f"row {c}")
    assert used == 9
