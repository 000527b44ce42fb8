"""PyTorch port: the tile blend (kernel B1's function).

The same JAX bin_splats output goes through the JAX Pallas kernel
(interpret mode on the CPU) and through the port's plain PyTorch version.
rgb and T agree within atol=1e-5: the Pallas kernel forms each pixel's
transmittance prefix in the log domain (exp of a sum of logs), the port as
a sequential product; JAX's own XLA and Pallas executors already differ by
that much (tests/test_golden.py:131)."""

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_fwd import (
    rasterize_binned_pallas_soa,
)
from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as k
from torch_port_util import both_splats, port_cfg, synthetic_splats

W, H = 96, 64


def _blend_both(arrays, cfg):
    """(JAX rgb, JAX T, port rgb, port T, port windows processed, binned)."""
    jax_s, _ = both_splats(arrays)
    binned = jax_bin(jax_s, cfg)
    j_rgb, j_t = rasterize_binned_pallas_soa(
        binned.table, binned.tile_starts, binned.tile_counts, 0, cfg)
    table = torch.from_numpy(np.array(binned.table))
    starts = torch.from_numpy(np.array(binned.tile_starts))
    counts = torch.from_numpy(np.array(binned.tile_counts))
    pcfg = port_cfg(cfg)
    p_rgb, p_t = blend_tiles(pcfg, pcfg.tiles_y, 1, table, starts, counts, 0)
    px, py = k.tile_pixel_grid(pcfg, pcfg.tiles_y)
    _, _, nproc = k.blend_tiles_plain(table, starts[:-1], counts, px, py,
                                      pcfg)
    return (np.asarray(j_rgb), np.asarray(j_t), p_rgb.numpy(), p_t.numpy(),
            nproc.numpy(), binned)


def _assert_close(j_rgb, j_t, p_rgb, p_t):
    assert p_rgb.shape == j_rgb.shape and p_t.shape == j_t.shape
    np.testing.assert_allclose(p_rgb, j_rgb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_t, j_t, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", [
    JaxMode.SH3, JaxMode.DEPTH, JaxMode.BILLBOARD, JaxMode.FLAT_BALL,
    JaxMode.GAUSSIAN_BALL,
])
def test_blend_matches_pallas_modes(mode):
    cfg = JaxConfig(width=W, height=H, mode=mode)
    arrays = synthetic_splats(700, W, H, seed=3)
    j_rgb, j_t, p_rgb, p_t, _, _ = _blend_both(arrays, cfg)
    assert j_rgb.max() > 0.1
    _assert_close(j_rgb, j_t, p_rgb, p_t)


def test_blend_early_stop_mid_list():
    """Opaque, dense: tiles saturate and stop before their lists end."""
    cfg = JaxConfig(width=W, height=H)
    arrays = synthetic_splats(3000, W, H, seed=4, scale=(3.0, 9.0),
                              opacity=(0.9, 1.0))
    j_rgb, j_t, p_rgb, p_t, nproc, binned = _blend_both(arrays, cfg)
    starts = np.asarray(binned.tile_starts).astype(np.int64)
    end = starts[1:]
    base = starts[:-1] // 128 * 128
    nchunks = np.where(end > starts[:-1], -(-(end - base) // 256), 0)
    assert np.any((nproc > 0) & (nproc < nchunks)), "no early stop fired"
    assert j_t.max() <= 1e-4 + 1e-6 or np.any(j_t < 1e-4)
    _assert_close(j_rgb, j_t, p_rgb, p_t)


def test_blend_empty_tiles():
    """Splats in one corner only: every other tile is empty (rgb 0, T 1)."""
    cfg = JaxConfig(width=W, height=H)
    arrays = synthetic_splats(60, W, H, seed=5, centre=(12, 10),
                              spread=(6, 5), scale=(1.0, 2.0))
    j_rgb, j_t, p_rgb, p_t, _, binned = _blend_both(arrays, cfg)
    empty = np.asarray(binned.tile_counts) == 0
    assert empty.sum() >= cfg.num_tiles - 4
    np.testing.assert_array_equal(p_rgb[empty], 0.0)
    np.testing.assert_array_equal(p_t[empty], 1.0)
    _assert_close(j_rgb, j_t, p_rgb, p_t)


def test_blend_unaligned_multi_window_tile():
    """A tile whose segment starts off the 128-row grid and spans at least
    3 windows, translucent enough that it never stops early."""
    cfg = JaxConfig(width=W, height=H)
    crowd = synthetic_splats(1200, W, H, seed=6, centre=(40, 24),
                             spread=(7, 7), scale=(0.6, 1.5),
                             opacity=(0.02, 0.05))
    others = synthetic_splats(90, W, H, seed=7, scale=(1.0, 2.0))
    arrays = {f: np.concatenate([others[f], crowd[f]]) for f in crowd}
    j_rgb, j_t, p_rgb, p_t, nproc, binned = _blend_both(arrays, cfg)
    starts = np.asarray(binned.tile_starts).astype(np.int64)
    base = starts[:-1] // 128 * 128
    nchunks = np.where(starts[1:] > starts[:-1],
                       -(-(starts[1:] - base) // 256), 0)
    hit = (starts[:-1] % 128 != 0) & (nchunks >= 3) & (nproc == nchunks)
    assert hit.any(), (starts[:-1] % 128, nchunks, nproc)
    _assert_close(j_rgb, j_t, p_rgb, p_t)


def test_blend_refuses_gradients():
    """The blend is differentiable w.r.t. the table only: starts and counts
    get no gradient; an empty frame gives the table a zero one; under
    no_grad no graph is built (the inference kernel B1's path)."""
    cfg = port_cfg(JaxConfig(width=32, height=32))
    table = torch.zeros((16, 600), requires_grad=True)
    starts = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    rgb, trans = blend_tiles(cfg, cfg.tiles_y, 1, table, starts, counts, 0)
    assert rgb.requires_grad and trans.requires_grad
    (g_table,) = torch.autograd.grad(rgb.sum() + trans.sum(), (table,),
                                     retain_graph=True)
    np.testing.assert_array_equal(g_table.numpy(), 0.0)
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(rgb.sum(), (starts,))
    with torch.no_grad():
        rgb, trans = blend_tiles(cfg, cfg.tiles_y, 1, table, starts, counts,
                                 0)
    assert not rgb.requires_grad and not trans.requires_grad


def test_kernel_wrapper_checks_inputs():
    cfg = port_cfg(JaxConfig(width=32, height=32))
    table = torch.zeros((16, 600))
    starts = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    # CPU tensors take any tile size (the plain version); only the CUDA
    # kernels are built for 16 (tests/test_torch_kernels_gpu.py)
    cfg8 = cfg.with_(tile_size=8)
    rgb8, trans8 = k.tile_raster_fwd(
        table, torch.zeros(cfg8.num_tiles + 1, dtype=torch.int32),
        torch.zeros(cfg8.num_tiles, dtype=torch.int32), 0, cfg8)
    assert rgb8.shape == (cfg8.num_tiles, 64, 3)
    np.testing.assert_array_equal(trans8.numpy(), 1.0)
    with pytest.raises(ValueError, match="tiles"):
        k.tile_raster_fwd(table, starts, counts, 0, cfg8)
    with pytest.raises(ValueError, match="int32"):
        k.tile_raster_fwd(table, starts.long(), counts, 0, cfg)
    with pytest.raises(ValueError, match="tiles"):
        k.tile_raster_fwd(table, starts[:-1], counts, 0, cfg)
    before = k.tile_raster_fwd.launches
    rgb, trans = k.tile_raster_fwd(table, starts, counts, 0, cfg)
    assert k.tile_raster_fwd.launches == before  # CPU: the plain version
    assert rgb.shape == (cfg.num_tiles, 256, 3)
    np.testing.assert_array_equal(trans.numpy(), 1.0)
