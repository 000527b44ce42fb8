"""Tile blend: the per-tile front-to-back compositing behind
``rasterize_tiles``.

Forward only in this slice: CUDA tensors go to the hand-written kernel B1
(ops/kernels/tile_raster_fwd.py), CPU tensors to its plain PyTorch version.
The gradient (kernels B2/B3 as an ``autograd.Function``) arrives with the
training slice; until then an input that requires grad raises instead of
returning a silently gradient-less image.

The JAX module's ``_tile_pixel_grid`` lives beside the kernel as
``tile_pixel_grid``: the kernel and its plain version must agree on it.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    tile_raster_fwd,
)


def blend_tiles(cfg: RenderConfig, local_rows: int, row_stride: int,
                table: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, row_offset: int = 0):
    """Blend all tiles of the row set {row_offset + s * row_stride}:
    attribute-major (16, Dpad) table -> rgb (T, P, 3), trans (T, P)."""
    if any(t.requires_grad for t in (table, starts, counts)):
        raise NotImplementedError(
            "blend_tiles has no gradient yet: the blend backward (kernels "
            "B2/B3) arrives with the training slice"
        )
    return tile_raster_fwd(table, starts, counts, row_offset, cfg,
                           local_rows, row_stride)
