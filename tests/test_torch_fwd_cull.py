"""PyTorch port: the exact warp cull of kernels B1, B2 and B4, through the
plain forward's ``cull`` option on the CPU.

The kernels skip a row for a warp when the row's 3-sigma rect misses the
warp's 16x4-pixel band (``warp_cull_plain``).  Here the plain forward with
the culled fragments skipped gives rgb, T, nproc and the checkpoints bit
for bit as without the cull: for B1 (no checkpoints), B2 (checkpoints) and
B4 (a seeded entering T, some tiles already saturated, with checkpoints),
in every render mode, on an opaque scene that stops early, on an
interleaved shard (tile rows 1, 3, ...), and on scenes of large splats
(the cull keeps nearly every pair) and of tiny ones (it drops most).
Scenes are projected splats made from a numpy seed.
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
SHARD = dict(row_offset=1, local_rows=2, row_stride=2)


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


def _binned(mode, scene, band):
    # every splat of the large scene reaches all 24 tiles
    cfg = RenderConfig(width=W, height=H, mode=RenderMode[mode],
                       table_budget_factor=32)
    row_offset = band.get("row_offset", 0)
    local_rows = band.get("local_rows", cfg.tiles_y)
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
        (256 // kf.SCAN_BLOCK, bs.table.shape[1]))
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


def _kept_share(bs, px, py):
    counts = bs.tile_counts.to(torch.int64)
    r = torch.arange(int(counts.max()))
    live = r[None, :] < counts[:, None]
    start = bs.tile_starts[:-1].to(torch.int64)[:, None]
    rows = bs.table[: binning.COL_RY + 1, torch.where(live, start + r, start)]
    kept = kf.warp_cull_plain(rows, live, px, py)
    return float(kept.sum()) / (float(live.sum()) * kf.BANDS)


CASES = [(m.name, "mix", {}) for m in RenderMode] + [
    ("SH3", "opaque", {}), ("SH3", "mix", SHARD), ("SH3", "large", {}),
    ("SH3", "tiny", {})]
IDS = [m.name.lower() for m in RenderMode] + [
    "opaque", "sh3_shard", "large", "tiny"]


@pytest.mark.parametrize("kernel", ["B1", "B2", "B4"])
@pytest.mark.parametrize("mode,scene,band", CASES, ids=IDS)
def test_culled_forward_is_bit_equal(kernel, mode, scene, band):
    cfg, bs, px, py = _binned(mode, scene, band)
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
    """The large scene keeps nearly every (row, band) pair, the tiny one
    drops most of them."""
    _, bs, px, py = _binned("SH3", scene, {})
    assert lo <= _kept_share(bs, px, py) <= hi


def test_opaque_scene_stops_early():
    """The opaque scene exercises the tile-wide early stop: some tile
    processes fewer windows than its rows span."""
    cfg, bs, px, py = _binned("SH3", "opaque", {})
    _, _, nproc = kf.blend_tiles_plain(bs.table, bs.tile_starts[:-1],
                                       bs.tile_counts, px, py, cfg)
    s = bs.tile_starts.to(torch.int64)
    nch = -(-(s[1:] - s[:-1] // 128 * 128) // 256)
    assert bool((nproc < nch).any())
