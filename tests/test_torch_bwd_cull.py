"""PyTorch port: the exact warp cull of kernels B3 and B5, through its plain
mirror ``warp_cull_plain`` on the CPU.

The kernels skip a row for a warp when the row's 3-sigma rect misses the
warp's band of 64 pixels: 8x8 at tile size 8, 16x4 at 16 (``band_rows``)
and an 8x8 square at 32 (``square_bands``; the forward's are 32x2).
Here, at tile sizes 8, 16 and 32, on scenes made from a numpy seed in
SH3, BILLBOARD, FLAT_BALL and an interleaved shard (tile rows 1, 3,
...):

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
# odd tile rows: 1, 3 of the 4 at tile size 16 (half the rows at any size)
SHARD = dict(row_offset=1, row_stride=2)
CASES = [("SH3", {}), ("BILLBOARD", {}), ("FLAT_BALL", {}), ("SH3", SHARD)]
IDS = ["sh3", "billboard", "flat_ball", "sh3_shard"]
TILES = [8, 16, 32]


def _binned(mode, band, ts):
    """A mix of small and large splats, binned for ``band``'s tile rows at
    tile size ``ts``."""
    small = synthetic_splats(500, W, H, seed=21, scale=(0.4, 1.5))
    large = synthetic_splats(60, W, H, seed=22, scale=(2.0, 6.0))
    arrays = {f: np.concatenate([large[f], small[f]]) for f in small}
    cfg = RenderConfig(width=W, height=H, mode=RenderMode[mode],
                       tile_size=ts)
    row_offset = band.get("row_offset", 0)
    row_stride = band.get("row_stride", 1)
    local_rows = cfg.tiles_y // 2 if band else cfg.tiles_y
    bs = binning.bin_splats(ProjectedSplats.from_numpy(**arrays), cfg,
                            row_offset, local_rows, row_stride)
    px, py = kf.tile_pixel_grid(cfg, local_rows, row_offset, row_stride)
    return cfg, bs, (row_offset, local_rows, row_stride), px, py


@pytest.mark.parametrize("ts", TILES)
@pytest.mark.parametrize("mode,band", CASES, ids=IDS)
def test_warp_cull_keeps_every_fragment(mode, band, ts):
    cfg, bs, _, px, py = _binned(mode, band, ts)
    counts = bs.tile_counts.to(torch.int64)
    r = torch.arange(int(counts.max()))
    live = r[None, :] < counts[:, None]
    start = bs.tile_starts[:-1].to(torch.int64)[:, None]
    rows = bs.table[: binning.COL_RY + 1, torch.where(live, start + r, start)]
    dx, dy, _, alpha, _ = kf.fragments(rows, live, px, py, cfg)

    square = kb.square_bands(ts)
    kept = kb.warp_cull_plain(rows, live, px, py, square)
    in_rect = (dx.abs() <= rows[binning.COL_RX][:, :, None]) \
        & (dy.abs() <= rows[binning.COL_RY][:, :, None]) & live[:, :, None]
    band = kf.band_of_pixel(ts, square)
    assert torch.equal(torch.bincount(band),
                       torch.full((ts * ts // kf.BAND_PIXELS,),
                                  kf.BAND_PIXELS))
    assert torch.equal(kept, torch.stack(
        [in_rect[:, :, band == w].any(2) for w in range(kept.shape[2])], 2))
    covered = kept[:, :, band]
    assert bool((alpha > 0).any())
    assert not bool(((alpha > 0) & ~covered).any())
    culled = live[:, :, None] & ~kept
    assert bool(culled.any()) and bool(kept.any())


@pytest.mark.parametrize("ts", TILES)
@pytest.mark.parametrize("mode,band", CASES, ids=IDS)
def test_culled_backward_is_bit_equal(mode, band, ts):
    cfg, bs, (row_offset, local_rows, row_stride), px, py = _binned(
        mode, band, ts)
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
