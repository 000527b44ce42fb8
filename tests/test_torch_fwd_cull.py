"""PyTorch port: the exact warp cull of kernels B1, B2 and B4, through the
plain forward's ``cull`` option on the CPU, at tile sizes 8, 16 and 32.

The kernels skip a row for a warp when the row's 3-sigma rect misses the
warp's band of 64 pixels (``warp_cull_plain``): all of an 8x8 tile, 16x4
at 16 (``band_rows``) and an 8x8 square at 32 (``square_bands``).  Here
the plain forward with the culled fragments skipped gives rgb, T, nproc
and the checkpoints bit for bit as without the cull: for B1 (no
checkpoints), B2 (checkpoints) and B4 (a seeded entering T, some tiles
already saturated, with checkpoints), in every render mode, on an opaque
scene that stops early, on an interleaved shard (tile rows 1, 3, ...),
and on scenes of large splats (the cull keeps nearly every pair) and of
tiny ones (it drops most).  The mirror's bands are the pixel groups of
``band_of_pixel``: its separable test equals the rect test at every pixel
of a band.  Scenes are projected splats made from a numpy seed.
"""

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as kf
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats
from torch_port_util import synthetic_splats

W, H = 96, 64
# odd tile rows: 1, 3 of the 4 at tile size 16 (half the rows at any size)
SHARD = dict(row_offset=1, row_stride=2)
TILES = [8, 16, 32]


def _scene(name):
    if name == "mix":  # small and large splats
        small = synthetic_splats(500, W, H, seed=31, scale=(0.4, 1.5))
        large = synthetic_splats(60, W, H, seed=32, scale=(2.0, 6.0))
        return {f: np.concatenate([large[f], small[f]]) for f in small}
    if name == "opaque":  # > 256 rows per tile, T < 1e-4 after a window
        return synthetic_splats(3000, W, H, seed=33, scale=(2.0, 6.0),
                                opacity=(0.95, 0.99))
    if name == "large":
        return synthetic_splats(120, W, H, seed=34, scale=(12.0, 24.0))
    assert name == "tiny"
    return synthetic_splats(800, W, H, seed=35, scale=(0.05, 0.2))


def _binned(mode, scene, band, ts=16):
    # every splat of the large scene reaches every tile (96 at tile 8)
    cfg = RenderConfig(width=W, height=H, mode=RenderMode[mode],
                       tile_size=ts, table_budget_rows=1 << 17)
    row_offset = band.get("row_offset", 0)
    local_rows = cfg.tiles_y // 2 if band else cfg.tiles_y
    row_stride = band.get("row_stride", 1)
    bs = binning.bin_splats(ProjectedSplats.from_numpy(**_scene(scene)), cfg,
                            row_offset, local_rows, row_stride)
    assert int(bs.truncated) == 0
    px, py = kf.tile_pixel_grid(cfg, local_rows, row_offset, row_stride)
    return cfg, bs, px, py


def _forward(kernel, cfg, bs, px, py, cull):
    """The plain B1, B2 or B4 (train variant) on one binned table:
    [rgb, T, nproc] and, for B2 and B4, the checkpoint buffer."""
    ckpt = None if kernel == "B1" else torch.zeros(
        (kf.ckpt_rows(px.shape[1]), bs.table.shape[1]))
    t_init = None
    if kernel == "B4":
        rng = np.random.default_rng(36)
        t = 0.2 + 0.8 * rng.uniform(size=px.shape)
        t[::7] = 5e-5  # these tiles enter saturated and stop at once
        t_init = torch.from_numpy(t.astype(np.float32))
    out = kf.blend_tiles_plain(bs.table, bs.tile_starts[:-1], bs.tile_counts,
                               px, py, cfg, ckpt=ckpt, t_init=t_init,
                               cull=cull)
    return list(out) + ([ckpt] if ckpt is not None else [])


def _rows(bs):
    """(rows (11, A, R), live (A, R)) of every tile's list."""
    counts = bs.tile_counts.to(torch.int64)
    r = torch.arange(int(counts.max()))
    live = r[None, :] < counts[:, None]
    start = bs.tile_starts[:-1].to(torch.int64)[:, None]
    return (bs.table[: binning.COL_RY + 1,
                     torch.where(live, start + r, start)], live)


def _kept_share(bs, px, py, ts):
    rows, live = _rows(bs)
    kept = kf.warp_cull_plain(rows, live, px, py, kf.square_bands(ts))
    return float(kept.sum()) / (float(live.sum()) * kept.shape[2])


CASES = [(m.name, "mix", {}) for m in RenderMode] + [
    ("SH3", "opaque", {}), ("SH3", "mix", SHARD), ("SH3", "large", {}),
    ("SH3", "tiny", {})]
IDS = [m.name.lower() for m in RenderMode] + [
    "opaque", "sh3_shard", "large", "tiny"]


@pytest.mark.parametrize("ts", TILES)
@pytest.mark.parametrize("kernel", ["B1", "B2", "B4"])
@pytest.mark.parametrize("mode,scene,band", CASES, ids=IDS)
def test_culled_forward_is_bit_equal(kernel, mode, scene, band, ts):
    cfg, bs, px, py = _binned(mode, scene, band, ts)
    full = _forward(kernel, cfg, bs, px, py, cull=False)
    culled = _forward(kernel, cfg, bs, px, py, cull=True)
    assert float(full[0].abs().max()) > 0
    for want, got in zip(full, culled):
        assert want.dtype == got.dtype
        if want.dtype == torch.float32:
            want, got = want.view(torch.int32), got.view(torch.int32)
        assert torch.equal(want, got)


@pytest.mark.parametrize("scene,lo,hi", [("large", 0.9, 1.0),
                                         ("tiny", 0.0, 0.5)])
def test_cull_share_of_scene(scene, lo, hi):
    """At tile 16 the large scene keeps nearly every (row, band) pair, the
    tiny one drops most of them."""
    _, bs, px, py = _binned("SH3", scene, {})
    assert lo <= _kept_share(bs, px, py, 16) <= hi


@pytest.mark.parametrize("ts", TILES)
def test_mirror_bands_are_pixel_groups(ts):
    """The mirror's (row, band) pairs are the rect test at the pixels of
    each band of ``band_of_pixel`` (8x8 squares at 32), 64 pixels each,
    and they cover every fragment with alpha > 0."""
    cfg, bs, px, py = _binned("SH3", "mix", {}, ts)
    rows, live = _rows(bs)
    square = kf.square_bands(ts)
    assert square == (ts == 32)
    kept = kf.warp_cull_plain(rows, live, px, py, square)
    band = kf.band_of_pixel(ts, square)
    assert torch.equal(torch.bincount(band),
                       torch.full((ts * ts // kf.BAND_PIXELS,),
                                  kf.BAND_PIXELS))
    dx, dy, _, alpha, _ = kf.fragments(rows, live, px, py, cfg)
    in_rect = (dx.abs() <= rows[binning.COL_RX][:, :, None]) \
        & (dy.abs() <= rows[binning.COL_RY][:, :, None]) & live[:, :, None]
    assert torch.equal(kept, torch.stack(
        [in_rect[:, :, band == w].any(2) for w in range(kept.shape[2])], 2))
    assert torch.equal(kf.warp_cull_pixels(rows, live, px, py, square),
                       kept[:, :, band])
    assert not bool(((alpha > 0) & ~kept[:, :, band]).any())


def test_opaque_scene_stops_early():
    """The opaque scene exercises the tile-wide early stop: some tile
    processes fewer windows than its rows span."""
    cfg, bs, px, py = _binned("SH3", "opaque", {})
    _, _, nproc = kf.blend_tiles_plain(bs.table, bs.tile_starts[:-1],
                                       bs.tile_counts, px, py, cfg)
    s = bs.tile_starts.to(torch.int64)
    nch = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
    assert bool((nproc < nch).any())
