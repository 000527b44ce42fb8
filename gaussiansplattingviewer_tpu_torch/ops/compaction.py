"""Budgeted stream compaction (the port of the JAX package's
``ops/compaction.py``).

``compact_by_mask`` keeps the JAX contract: a stable partition moves the
selected rows to the front, the first ``budget`` of them are taken, and
``dropped`` counts the selected rows past the budget.  The budget bounds a
shard's work by its share of the image (parallel/sharded_render.py uses it
for band compaction, the band pre-cull and the splat gather), and the
port's rows, ``kept`` and ``dropped`` equal JAX's.

The take is one ``index_select`` under autograd.  The selection is a
permutation, so each source row receives at most one gradient row: its
backward adds onto distinct rows and gives the same bits on every run, and
rows past the budget get zero gradient.  JAX's inverse-permutation VJP and
its stride-interleaved gather (``ops/stride_gather.py``) avoid TPU scatters
and penalties and are not ported.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats


def compact_by_mask(tree, mask: torch.Tensor, budget: int):
    """Compact every tensor of the sequence ``tree`` (same leading dim as
    ``mask``) to its ``mask``-selected rows, padded or truncated to
    ``budget`` rows.

    Returns (compact tuple, kept (budget,) bool, dropped () int32):
      * rows [0, min(count, budget)) of each compact tensor are the
        selected rows in their original order;
      * ``kept`` flags the compact rows that were selected (the tail holds
        unselected rows: mask them with ``kept`` before use);
      * ``dropped`` counts the selected rows past the budget.
    """
    n = mask.shape[0]
    budget = min(budget, n)
    sel = torch.sort((~mask).to(torch.int32), stable=True)[1][:budget]
    count = mask.sum().to(torch.int32)
    kept = torch.arange(budget, device=mask.device) < torch.clamp(count,
                                                                  max=budget)
    dropped = torch.clamp(count - budget, min=0)
    return tuple(leaf.index_select(0, sel) for leaf in tree), kept, dropped


def pack_splats(splats: ProjectedSplats):
    """ProjectedSplats -> ((N, 16) f32 rows, (N,) bool valid), the rows in
    the table layout of ``binning.pack_table`` (so one row gather or one
    collective moves a splat set)."""
    return binning.pack_table(splats), splats.valid


def unpack_splats(rows: torch.Tensor, valid: torch.Tensor) -> ProjectedSplats:
    """Inverse of ``pack_splats`` (column views of ``rows``)."""
    b = binning
    return ProjectedSplats(
        mean2d=rows[:, b.COL_CX : b.COL_CY + 1],
        depth=rows[:, b.COL_DEPTH],
        conic=rows[:, b.COL_A : b.COL_C + 1],
        radius=rows[:, b.COL_RX : b.COL_RY + 1],
        color=rows[:, b.COL_R : b.COL_BCH + 1],
        opacity=rows[:, b.COL_OPACITY],
        valid=valid,
    )


def compact_splats(splats: ProjectedSplats, mask: torch.Tensor, budget: int):
    """``compact_by_mask`` of a splat set through one packed row array.

    pack_table zeroes the opacity of invalid splats, and unpacking keeps
    that; invalid splats never bin, so nothing downstream sees it."""
    rows, valid = pack_splats(splats)
    (rows_c, valid_c), kept, dropped = compact_by_mask((rows, valid), mask,
                                                       budget)
    return unpack_splats(rows_c, valid_c), kept, dropped
