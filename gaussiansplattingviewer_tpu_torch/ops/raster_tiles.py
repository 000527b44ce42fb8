"""Tile-binned rasterization: the production render path.

project -> bin_splats (ops/binning.py) -> blend_tiles (ops/blend.py, kernel
B1 on the card) -> tiles assembled into the image, background composited.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats


def _tiles_to_image(rgb_tiles, trans_tiles, cfg: RenderConfig):
    """(T, P, ...) tile blocks -> cropped (H, W, ...) image."""
    ts = cfg.tile_size
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    img = rgb_tiles.reshape(ty_n, tx_n, ts, ts, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(ty_n * ts, tx_n * ts, 3)
    trans = trans_tiles.reshape(ty_n, tx_n, ts, ts)
    trans = trans.permute(0, 2, 1, 3).reshape(ty_n * ts, tx_n * ts)
    return img[: cfg.height, : cfg.width], trans[: cfg.height, : cfg.width]


def debug_counters(splats: ProjectedSplats, img):
    """cfg.debug sanitizer counters: valid splats with non-finite projected
    fields, and non-finite output pixels."""
    finite = torch.ones_like(splats.valid)
    for field in (
        splats.mean2d, splats.conic, splats.color, splats.radius,
        splats.depth[:, None], splats.opacity[:, None],
    ):
        finite = finite & torch.all(torch.isfinite(field), dim=-1)
    bad_splats = torch.sum(splats.valid & ~finite).to(torch.int32)
    bad_pixels = torch.sum(~torch.isfinite(img)).to(torch.int32)
    return {"nonfinite_splats": bad_splats, "nonfinite_pixels": bad_pixels}


def rasterize_tiles(splats: ProjectedSplats, cfg: RenderConfig,
                    return_aux: bool = False):
    """Tile-binned render of projected splats -> (H, W, 3) image."""
    binned = binning.bin_splats(splats, cfg)
    rgb_tiles, trans_tiles = blend_tiles(
        cfg, cfg.tiles_y, 1, binned.table, binned.tile_starts,
        binned.tile_counts, 0,
    )
    img, trans = _tiles_to_image(rgb_tiles, trans_tiles, cfg)
    img = img + cfg.background * trans[..., None]
    if return_aux:
        aux = {
            "transmittance": trans,
            "num_duplicates": binned.num_duplicates,
            "overflow": binned.overflow,
            "truncated": binned.truncated,
        }
        if cfg.debug:
            aux.update(debug_counters(splats, img))
        return img, aux
    return img
