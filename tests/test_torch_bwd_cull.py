"""PyTorch port: the exact warp cull of kernels B3 and B5, through its plain
mirror ``warp_cull_plain`` on the CPU.

The kernels skip a row for a warp when the row's 3-sigma rect misses the
warp's 16x4-pixel band.  Here, on scenes made from a numpy seed in SH3,
BILLBOARD, FLAT_BALL and an interleaved shard (tile rows 1, 3, ...):

  * the mirror's separable test (columns x rows) equals the rect test at
    every pixel of the band, and every fragment with alpha > 0 lies in a
    kept (row, band) pair, while the cull does drop pairs;
  * the plain backward with the culled fragments zeroed equals the plain
    backward without the cull, bit for bit.

The kernels' launcher also refuses alpha_clamp = 1, whose zero divisor
their division does not take.
"""

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_bwd as kb
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as kf
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats
from torch_port_util import synthetic_splats

W, H = 96, 64
SHARD = dict(row_offset=1, local_rows=2, row_stride=2)
CASES = [("SH3", {}), ("BILLBOARD", {}), ("FLAT_BALL", {}), ("SH3", SHARD)]
IDS = ["sh3", "billboard", "flat_ball", "sh3_shard"]


def _binned(mode, band):
    """A mix of small and large splats, binned for ``band``'s tile rows."""
    small = synthetic_splats(500, W, H, seed=21, scale=(0.4, 1.5))
    large = synthetic_splats(60, W, H, seed=22, scale=(2.0, 6.0))
    arrays = {f: np.concatenate([large[f], small[f]]) for f in small}
    cfg = RenderConfig(width=W, height=H, mode=RenderMode[mode])
    row_offset = band.get("row_offset", 0)
    local_rows = band.get("local_rows", cfg.tiles_y)
    row_stride = band.get("row_stride", 1)
    bs = binning.bin_splats(ProjectedSplats.from_numpy(**arrays), cfg,
                            row_offset, local_rows, row_stride)
    px, py = kf.tile_pixel_grid(cfg, local_rows, row_offset, row_stride)
    return cfg, bs, (row_offset, local_rows, row_stride), px, py


@pytest.mark.parametrize("mode,band", CASES, ids=IDS)
def test_warp_cull_keeps_every_fragment(mode, band):
    cfg, bs, _, px, py = _binned(mode, band)
    counts = bs.tile_counts.to(torch.int64)
    r = torch.arange(int(counts.max()))
    live = r[None, :] < counts[:, None]
    start = bs.tile_starts[:-1].to(torch.int64)[:, None]
    rows = bs.table[: binning.COL_RY + 1, torch.where(live, start + r, start)]
    dx, dy, _, alpha, _ = kf.fragments(rows, live, px, py, cfg)

    kept = kb.warp_cull_plain(rows, live, px, py)
    in_rect = (dx.abs() <= rows[binning.COL_RX][:, :, None]) \
        & (dy.abs() <= rows[binning.COL_RY][:, :, None]) & live[:, :, None]
    a_n, r_n, p_n = in_rect.shape
    assert torch.equal(kept, in_rect.reshape(a_n, r_n, kb.BANDS, -1).any(3))
    covered = kept.repeat_interleave(p_n // kb.BANDS, dim=2)
    assert bool((alpha > 0).any())
    assert not bool(((alpha > 0) & ~covered).any())
    culled = live[:, :, None] & ~kept
    assert bool(culled.any()) and bool(kept.any())


@pytest.mark.parametrize("mode,band", CASES, ids=IDS)
def test_culled_backward_is_bit_equal(mode, band):
    cfg, bs, (row_offset, local_rows, row_stride), px, py = _binned(mode, band)
    _, trans, ckpt, nproc = kf.tile_raster_fwd_train(
        bs.table, bs.tile_starts, bs.tile_counts, row_offset, cfg,
        local_rows, row_stride)
    rng = np.random.default_rng(23)
    g_rgb = torch.from_numpy(rng.normal(size=(*trans.shape, 3))
                             .astype(np.float32))
    g_trans = torch.from_numpy(rng.normal(size=trans.shape)
                               .astype(np.float32))
    args = (bs.table, bs.tile_starts[:-1], bs.tile_counts, nproc, ckpt, px,
            py, g_rgb, g_trans, trans, cfg)
    full = kb.blend_tiles_bwd_plain(*args)
    culled = kb.blend_tiles_bwd_plain(*args, cull=True)
    assert float(full.abs().max()) > 0
    assert torch.equal(full.view(torch.int32), culled.view(torch.int32))


def test_kernel_launch_rejects_alpha_clamp_one():
    """The kernels divide by max(1 - alpha, 1 - alpha_clamp) with a
    reciprocal that needs a nonzero divisor, so the launcher refuses
    alpha_clamp = 1 before it builds or launches anything."""
    cfg = RenderConfig(width=32, height=32, alpha_clamp=1.0)
    table = torch.zeros((binning.TABLE_WIDTH, 600))
    with pytest.raises(ValueError, match="alpha_clamp < 1"):
        kb._bwd_cuda(table, None, None, None, None, None, 0, None, None,
                     None, None, None, None, cfg, cfg.num_tiles, 1)
