"""Differentiable tile blend: the per-tile front-to-back compositing behind
``rasterize_tiles``, the counterpart of the JAX package's ``blend_tiles``
custom_vjp.

Forward: under autograd with a table that requires grad, kernel B2 (the
train forward, which also keeps the backward's residuals); otherwise kernel
B1, so serving and eval renders under ``no_grad`` never pay for the
residuals.  Backward: kernel B3, a back-to-front re-traversal from B2's
checkpoints.  The kernels live in ops/kernels/; CPU tensors run their plain
PyTorch versions in both directions.

The JAX module's ``_tile_pixel_grid`` lives beside the kernels as
``tile_pixel_grid``: the kernels and their plain versions must agree on it.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_bwd import (
    tile_raster_bwd,
)
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    tile_raster_fwd,
    tile_raster_fwd_train,
)


class _BlendTiles(torch.autograd.Function):
    """(table, starts, counts) -> (rgb, trans); gradient w.r.t. the table
    only (starts and counts are integers)."""

    @staticmethod
    def forward(ctx, table, starts, counts, cfg, local_rows, row_stride,
                row_offset):
        rgb, trans, ckpt, nproc = tile_raster_fwd_train(
            table, starts, counts, row_offset, cfg, local_rows, row_stride)
        ctx.save_for_backward(table, starts, counts, trans, ckpt, nproc)
        ctx.args = (cfg, local_rows, row_stride, row_offset)
        return rgb, trans

    @staticmethod
    def backward(ctx, g_rgb, g_trans):
        table, starts, counts, trans, ckpt, nproc = ctx.saved_tensors
        cfg, local_rows, row_stride, row_offset = ctx.args
        g_rgb = (torch.zeros((*trans.shape, 3), dtype=trans.dtype,
                             device=trans.device)
                 if g_rgb is None else g_rgb.contiguous())
        g_trans = (torch.zeros_like(trans) if g_trans is None
                   else g_trans.contiguous())
        g_table = tile_raster_bwd(
            table, starts, counts, nproc, ckpt, row_offset, g_rgb, g_trans,
            trans, cfg, local_rows, row_stride)
        return g_table, None, None, None, None, None, None


def blend_tiles(cfg: RenderConfig, local_rows: int, row_stride: int,
                table: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, row_offset: int = 0):
    """Blend all tiles of the row set {row_offset + s * row_stride}:
    attribute-major (16, Dpad) table -> rgb (T, P, 3), trans (T, P),
    differentiable w.r.t. the table."""
    # grad mode is off inside Function.forward, so the choice of forward
    # kernel is made here
    if torch.is_grad_enabled() and table.requires_grad:
        return _BlendTiles.apply(table, starts, counts, cfg, local_rows,
                                 row_stride, row_offset)
    return tile_raster_fwd(table, starts, counts, row_offset, cfg,
                           local_rows, row_stride)
