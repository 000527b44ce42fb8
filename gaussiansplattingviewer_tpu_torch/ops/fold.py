"""Splat-id gradient fold: the compact gradient rows of the fused path's
backward (kernel B5, ops/fused.py) -> per-splat sums.

The port of the JAX ``ops/fold.py`` ``fold_rows_by_id``.  Row COL_COUNT of
the compact buffer holds the owning splat id as an exact f32 integer (the
fused table carries it, B5 copies it beside the gradients); columns no row
landed on hold id 0 and zero gradient and fold harmlessly.

The JAX pipeline (bf16 pair packing, a sort by id, blocked cumsums, a
compensated double-f32 scan and probe-sort segment ends) exists to avoid a
scatter on the TPU.  Here the fold is one ``index_add_`` into an f64
buffer: the f64 accumulation stands in for the compensated sums' accuracy.
Plain PyTorch, as the JAX fold is XLA and not Pallas.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.ops import binning


def fold_rows_by_id(g_soa: torch.Tensor, n: int,
                    fold_bf16: bool) -> torch.Tensor:
    """(TABLE_WIDTH, G) compact attribute-major gradient rows -> (n,
    TABLE_WIDTH) f32 per-splat sums (columns >= GRAD_WIDTH zero).  With
    ``fold_bf16`` each row's gradients are rounded to bf16 first (the JAX
    package's ``grad_fold_bf16`` semantics)."""
    ids = g_soa[binning.COL_COUNT].to(torch.int64)
    rows = g_soa[: binning.GRAD_WIDTH].T
    if fold_bf16:
        rows = rows.to(torch.bfloat16)
    acc = torch.zeros((n, binning.GRAD_WIDTH), dtype=torch.float64,
                      device=g_soa.device)
    acc.index_add_(0, ids, rows.to(torch.float64))
    out = torch.zeros((n, binning.TABLE_WIDTH), dtype=torch.float32,
                      device=g_soa.device)
    out[:, : binning.GRAD_WIDTH] = acc
    return out
