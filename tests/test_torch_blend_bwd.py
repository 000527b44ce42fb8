"""PyTorch port: kernels B2 (the train forward) and B3 (the blend backward)
at function level, through their plain PyTorch versions on the CPU.

The same JAX bin_splats table goes through both packages.

B2 against JAX ``rasterize_binned_pallas_train`` (interpret mode): rgb and
T within 1e-5 (the Pallas kernel forms transmittance as exp of a sum of
logs, the port as a sequential product), ``nproc`` equal, and ckpt within
1e-6 on every window the backward reads.

B3 against two references on the same random cotangents, per table column
c, within a fraction of max|g[c]|:
  * ``jax.vjp`` of the XLA executor's ``blend_tiles`` (global pixel frame,
    like the port): 1e-5, on scenes where no tile stops early (the XLA
    executor checks its early stop every 16 rows, the kernels every 256,
    so with an early stop the two differ by design in the last rows);
  * JAX ``blend_bwd_pallas_soa`` (interpret mode) on its own residuals:
    3e-5, tests/test_grads.py's Pallas budget (its tile-local moment
    recombination adds ~2e-5 on the conic columns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.blend import blend_tiles as jax_blend
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_bwd import (
    blend_bwd_pallas_soa,
)
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_fwd import (
    rasterize_binned_pallas_train,
)
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_bwd as kb
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as kf
from torch_port_util import both_splats, port_cfg, synthetic_splats

W, H = 96, 64


def _scene(kind):
    if kind == "early_stop":
        return synthetic_splats(3000, W, H, seed=4, scale=(3.0, 9.0),
                                opacity=(0.9, 1.0))
    if kind == "multi_window":
        crowd = synthetic_splats(1200, W, H, seed=6, centre=(40, 24),
                                 spread=(7, 7), scale=(0.6, 1.5),
                                 opacity=(0.02, 0.05))
        others = synthetic_splats(90, W, H, seed=7, scale=(1.0, 2.0))
        return {f: np.concatenate([others[f], crowd[f]]) for f in crowd}
    return synthetic_splats(700, W, H, seed=3)


def _train_both(arrays, cfg):
    jax_s, _ = both_splats(arrays)
    binned = jax_bin(jax_s, cfg)
    jax_out = rasterize_binned_pallas_train(
        binned.table, binned.tile_starts, binned.tile_counts, 0, cfg)
    table = torch.from_numpy(np.array(binned.table))
    starts = torch.from_numpy(np.array(binned.tile_starts))
    counts = torch.from_numpy(np.array(binned.tile_counts))
    port = kf.tile_raster_fwd_train(table, starts, counts, 0, port_cfg(cfg))
    return binned, jax_out, (table, starts, counts), port


def _read_windows(starts, nproc):
    """(tile, column) of every checkpoint window the backward reads: each
    processed 128-row block with a live row, but the tile's first."""
    s = starts.numpy().astype(np.int64)
    start, end = s[:-1], s[1:]
    base = start // 128 * 128
    nch = np.where(end > start, -(-(end - base) // 256), 0)
    out = []
    for t in range(len(start)):
        for blk in range(1, 2 * min(int(nproc[t]), int(nch[t]))):
            c = base[t] + blk * 128
            if c < end[t]:
                out.append((t, c))
    return out


def _cotangents(shape_rgb, shape_t, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_rgb).astype(np.float32),
            rng.normal(size=shape_t).astype(np.float32))


def _assert_columns(got, want, rel):
    used = 0
    for c in range(16):
        scale = np.abs(want[c]).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got[c], 0.0, err_msg=f"col {c}")
            continue
        used += 1
        np.testing.assert_allclose(got[c], want[c], atol=rel * scale, rtol=0,
                                   err_msg=f"col {c}")
    return used


@pytest.mark.parametrize("mode,kind", [
    (JaxMode.SH3, "plain"), (JaxMode.BILLBOARD, "plain"),
    (JaxMode.GAUSSIAN_BALL, "plain"), (JaxMode.SH3, "early_stop"),
    (JaxMode.SH3, "multi_window"),
])
def test_train_forward_matches_pallas(mode, kind):
    cfg = JaxConfig(width=W, height=H, mode=mode)
    _, (j_rgb, j_t, j_ck, j_np), (_, starts, _), (rgb, trans, ckpt, nproc) \
        = _train_both(_scene(kind), cfg)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_t), atol=1e-5,
                               rtol=0)
    assert nproc.dtype == torch.int32
    np.testing.assert_array_equal(nproc.numpy(), np.asarray(j_np))
    windows = _read_windows(starts, nproc.numpy())
    assert windows
    j_ck = np.asarray(j_ck)
    for _, c in windows:
        np.testing.assert_allclose(ckpt[:, c:c + 128].numpy(),
                                   j_ck[:, c:c + 128], atol=1e-6, rtol=0)
    if kind == "early_stop":
        s = starts.numpy().astype(np.int64)
        nch = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
        assert np.any(nproc.numpy() < nch), "no early stop fired"


@pytest.mark.parametrize("mode,kind", [
    (JaxMode.SH3, "plain"), (JaxMode.DEPTH, "plain"),
    (JaxMode.BILLBOARD, "plain"), (JaxMode.FLAT_BALL, "plain"),
    (JaxMode.GAUSSIAN_BALL, "plain"), (JaxMode.SH3, "multi_window"),
])
def test_blend_backward_matches_xla_vjp(mode, kind):
    cfg = JaxConfig(width=W, height=H, mode=mode)
    binned, _, (table, starts, counts), (_, trans, ckpt, nproc) = \
        _train_both(_scene(kind), cfg)
    g_rgb, g_t = _cotangents((cfg.num_tiles, 256, 3), (cfg.num_tiles, 256),
                             seed=10)
    got = kb.tile_raster_bwd(table, starts, counts, nproc, ckpt, 0,
                             torch.from_numpy(g_rgb), torch.from_numpy(g_t),
                             trans, port_cfg(cfg)).numpy()
    _, vjp = jax.vjp(
        lambda tb: jax_blend(cfg, False, cfg.tiles_y, 1, tb,
                             binned.tile_starts, binned.tile_counts,
                             jnp.int32(0)), binned.table)
    (want,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_t)))
    used = _assert_columns(got, np.asarray(want), 1e-5)
    assert used == (9 if mode in (JaxMode.SH3, JaxMode.DEPTH) else 3)


@pytest.mark.parametrize("kind", ["plain", "early_stop"])
def test_blend_backward_matches_pallas(kind):
    cfg = JaxConfig(width=W, height=H)
    binned, (_, j_t, j_ck, j_np), (table, starts, counts), \
        (_, trans, ckpt, nproc) = _train_both(_scene(kind), cfg)
    g_rgb, g_t = _cotangents((cfg.num_tiles, 256, 3), (cfg.num_tiles, 256),
                             seed=11)
    got = kb.tile_raster_bwd(table, starts, counts, nproc, ckpt, 0,
                             torch.from_numpy(g_rgb), torch.from_numpy(g_t),
                             trans, port_cfg(cfg)).numpy()
    want = blend_bwd_pallas_soa(
        binned.table, binned.tile_starts, binned.tile_counts, j_np, j_ck, 0,
        jnp.asarray(g_rgb), jnp.asarray(g_t), j_t, cfg)
    assert _assert_columns(got, np.asarray(want), 3e-5) == 9


def test_backward_writes_only_processed_live_rows():
    """Rows of windows skipped by the early stop, dead rows and columns
    9-15 keep exactly zero gradient."""
    cfg = JaxConfig(width=W, height=H)
    _, _, (table, starts, counts), (_, trans, ckpt, nproc) = \
        _train_both(_scene("early_stop"), cfg)
    g_rgb, g_t = _cotangents((cfg.num_tiles, 256, 3), (cfg.num_tiles, 256),
                             seed=12)
    g = kb.tile_raster_bwd(table, starts, counts, nproc, ckpt, 0,
                           torch.from_numpy(g_rgb), torch.from_numpy(g_t),
                           trans, port_cfg(cfg)).numpy()
    s = starts.numpy().astype(np.int64)
    written = np.zeros(table.shape[1], bool)
    for t in range(cfg.num_tiles):
        base = s[t] // 128 * 128
        written[s[t]:min(s[t + 1], base + 256 * int(nproc[t]))] = True
    assert (~written[: s[-1]]).any()  # some rows were skipped
    np.testing.assert_array_equal(g[:, ~written], 0.0)
    np.testing.assert_array_equal(g[9:], 0.0)
    assert np.abs(g[:, written]).max() > 0


def test_bwd_wrapper_checks_inputs():
    cfg = port_cfg(JaxConfig(width=32, height=32))
    table = torch.zeros((16, 600))
    starts = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    rgb, trans, ckpt, nproc = kf.tile_raster_fwd_train(table, starts, counts,
                                                       0, cfg)
    assert ckpt.shape == (2, 600) and nproc.shape == (cfg.num_tiles,)
    g_rgb = torch.zeros_like(rgb)
    args = (table, starts, counts, nproc, ckpt, 0, g_rgb, trans, trans, cfg)
    with pytest.raises(ValueError, match="int32"):
        kb.tile_raster_bwd(*args[:3], nproc.long(), *args[4:])
    with pytest.raises(ValueError, match="expected"):
        kb.tile_raster_bwd(*args[:6], g_rgb[:, :, :2], *args[7:])
    before = kb.tile_raster_bwd.launches
    g = kb.tile_raster_bwd(*args)
    assert kb.tile_raster_bwd.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(g.numpy(), 0.0)
