"""Tile-binned rasterization: the production render path.

project -> bin_splats (ops/binning.py) -> blend_tiles (ops/blend.py, kernel
B1 on the card, or the tile executor with ``use_kernel=False``) -> tiles
assembled into the image, background composited.  cfg.fused_grad takes the
fused prefix/residual path instead: bin_splats_presort -> blend_fused
(ops/fused.py, kernels B1/B2, B4, B5), on the kernels only; the tile
executor keeps the classic path regardless, as JAX's XLA executor does
(its ``raster_tiles.py:68``), so a parity check of the two compares
independent code paths.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
from gaussiansplattingviewer_tpu_torch.ops.fused import blend_fused
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats
from gaussiansplattingviewer_tpu_torch.utils import profiling


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
    shape = splats.transform if splats.surfel else splats.conic
    for field in (
        splats.mean2d, shape, splats.color, splats.radius,
        splats.depth[:, None], splats.opacity[:, None],
    ):
        finite = finite & torch.all(torch.isfinite(field), dim=-1)
    bad_splats = torch.sum(splats.valid & ~finite).to(torch.int32)
    bad_pixels = torch.sum(~torch.isfinite(img)).to(torch.int32)
    return {"nonfinite_splats": bad_splats, "nonfinite_pixels": bad_pixels}


def rasterize_tiles(splats: ProjectedSplats, cfg: RenderConfig,
                    return_aux: bool = False, use_kernel: bool = True):
    """Tile-binned render of projected splats -> (H, W, 3) image, the blend
    on the kernels or, with ``use_kernel=False``, on the tile executor.
    The fused path's aux adds grad_rows_needed and grad_rows_dropped (0
    outside autograd), and its ``truncated`` sums both passes'
    truncation.  Span ``blend``: after binning, to the composited
    image."""
    fused = cfg.fused_grad and use_kernel
    if fused:
        binned = binning.bin_splats_presort(splats, cfg)
    else:
        binned = binning.bin_splats(splats, cfg)
    with profiling.span("blend", splats.depth.device):
        if fused:
            rgb_tiles, trans_tiles, diag = blend_fused(
                cfg, cfg.tiles_y, 1, binned.table_src, binned.rows_sorted,
                binned.starts_full, 0, binned.surfel)
            truncated = (diag[0] + diag[1]).to(torch.int32)
            extra = {"grad_rows_needed": diag[2],
                     "grad_rows_dropped": diag[3]}
        else:
            rgb_tiles, trans_tiles = blend_tiles(
                cfg, cfg.tiles_y, 1, binned.table, binned.tile_starts,
                binned.tile_counts, 0, use_kernel, binned.surfel,
            )
            truncated, extra = binned.truncated, {}
        img, trans = _tiles_to_image(rgb_tiles, trans_tiles, cfg)
        img = img + cfg.background * trans[..., None]
    num_dup, overflow = binned.num_duplicates, binned.overflow
    if return_aux:
        aux = {
            "transmittance": trans,
            "num_duplicates": num_dup,
            "overflow": overflow,
            "truncated": truncated,
            **extra,
        }
        if cfg.debug:
            aux.update(debug_counters(splats, img))
        return img, aux
    return img
