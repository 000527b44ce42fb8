"""The fused prefix/residual path: budgeted prefix gather, a seeded
residual pass and a compact backward folded by splat id, as one
differentiable op (the port of the JAX ``ops/fused.py``).

  forward
    1. PREFIX gather: the first min(count, K) rows of each tile
       (K = cfg.prefix_rows; their sum bounded by prefix_budget_rows).
       Tiles that saturate early never need the rest.
    2. pass 1 blends them (kernel B1; B2 under autograd) -> rgb1, trans1.
    3. tiles that neither saturated nor fit in K get a RESIDUAL pass: their
       remaining rows are gathered (residual_budget_rows) and blended with
       each pixel's transmittance seeded from trans1 (kernel B4): exact by
       associativity, out = rgb1 + rgb2, T = trans2.
  backward
    4. kernel B5 runs once per pass, the residual pass first: gradients
       land at per-tile compact offsets with the owning splat id beside
       them.  Pass 1's suffix carry is seeded with g . rgb2, so its splats
       see the residual splats behind them.
    5. one id fold (ops/fold.py) over the rows the passes processed gives
       the (N, 16) gradient of the packed table.

With prefix_rows == 0 it is one full pass whose backward still takes the
compact id fold.  Tiles whose gradient region passes the budget lose their
gradients for the step and are counted in ``grad_rows_dropped``.

Not carried over: the JAX path's stride-interleaved gather order
(ops/stride_gather.py), a TPU gather-penalty device; rows are gathered in
natural order.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.binning import (
    KERNEL_CHUNK,
    SEGMENT_ALIGN,
    TABLE_PAD,
    TABLE_WIDTH,
)
from gaussiansplattingviewer_tpu_torch.ops.fold import fold_rows_by_id
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_bwd import (
    tile_raster_bwd_fused,
)
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    check_tile_size,
    tile_raster_fwd,
    tile_raster_fwd_seeded,
    tile_raster_fwd_train,
)


def _exclusive(x):
    """[0, x0, x0 + x1, ...] (len(x) + 1,) int64."""
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=x.device),
                      torch.cumsum(x, 0)])


def _ragged_rows(starts_c, shift, rows_sorted, budget):
    """Budgeted ragged per-tile gather of ``rows_sorted``: output position
    i belongs to tile t (the rightmost with starts_c[t] <= i) and reads
    index i + shift[t].  Positions past the last segment read a clamped
    (dead) index: they lie outside every segment, so the kernels skip
    them."""
    dev = rows_sorted.device
    cap = rows_sorted.shape[0]
    if cap == 0:
        return torch.zeros((budget,), dtype=torch.int64, device=dev)
    i = torch.arange(budget, device=dev)
    t = torch.searchsorted(starts_c.to(torch.int64), i, right=True) - 1
    t = t.clamp(0, shift.shape[0] - 1)
    return rows_sorted[(i + shift[t]).clamp(0, cap - 1)]


def _gather_table(table_src, rows):
    """The attribute-major (16, len(rows) + TABLE_PAD) table of the rows
    ``rows`` of ``table_src``, the splat id in row COL_COUNT (an exact f32
    integer; B5 copies it beside the gradients)."""
    m = rows.shape[0]
    table = torch.zeros((TABLE_WIDTH, m + TABLE_PAD), dtype=torch.float32,
                        device=table_src.device)
    table[:, :m] = table_src[rows].T
    table[binning.COL_COUNT, :m] = rows.to(torch.float32)
    return table


def _num_chunks(starts_c, counts):
    """Windows each tile's segment spans, as the kernels count them."""
    start = starts_c[:-1].to(torch.int64)
    end = start + counts.to(torch.int64)
    base = start // SEGMENT_ALIGN * SEGMENT_ALIGN
    return torch.where(counts > 0, (end - base + KERNEL_CHUNK - 1)
                       // KERNEL_CHUNK, torch.zeros_like(end))


def _round_chunk(b: int) -> int:
    return -(-b // KERNEL_CHUNK) * KERNEL_CHUNK


def _grad_budget2(cfg: RenderConfig, num_tiles: int) -> int:
    """Compact-gradient budget of the RESIDUAL pass:
    cfg.grad_residual_budget_rows if set, else residual rows + one window
    per tile."""
    return _round_chunk(cfg.grad_residual_budget_rows or (
        int(cfg.residual_budget_rows) + (num_tiles + 1) * KERNEL_CHUNK))


def _grad_budget(cfg: RenderConfig, table_rows: int, num_tiles: int) -> int:
    """Compact-gradient budget of pass 1: cfg.grad_budget_rows if set,
    else the table's width + one alignment-slack window per tile."""
    return _round_chunk(cfg.grad_budget_rows or (
        table_rows + (num_tiles + 1) * KERNEL_CHUNK))


def _forward(cfg: RenderConfig, local_rows, row_stride, table_src,
             rows_sorted, starts_full, row_offset, train: bool) -> dict:
    """Both passes of the forward on detached values; ``train`` takes the
    kernels that keep the backward's residuals (B2 and B4's train
    variant)."""
    n = table_src.shape[0]
    assert n < (1 << 24), "splat ids must be exact in f32"
    table_src = table_src.detach()
    num_tiles = local_rows * cfg.tiles_x
    cap = rows_sorted.shape[0]
    starts_full = starts_full.to(torch.int64)
    counts_full = starts_full[1:] - starts_full[:-1]
    k = int(cfg.prefix_rows)
    if k > 0:
        assert cfg.residual_budget_rows > 0, (
            "prefix_rows requires residual_budget_rows")
    i32 = torch.int32

    # ---- pass 1: each tile's first min(count, K) rows
    cmin = counts_full.clamp(max=k) if k > 0 else counts_full
    kb = cfg.prefix_budget_rows or cfg.table_budget_rows or (
        cfg.table_budget_factor * n)
    kb = min(kb, cap)
    pstarts = _exclusive(cmin)
    ptrunc = (pstarts[num_tiles] - kb).clamp(min=0)
    pstarts_c = pstarts.clamp(max=kb)
    pcounts = (pstarts_c[1:] - pstarts_c[:-1]).to(i32)
    pstarts_c = pstarts_c.to(i32)
    if k > 0:
        rows1 = _ragged_rows(pstarts_c, starts_full[:-1] - pstarts_c[:-1],
                             rows_sorted, kb)
    else:
        rows1 = rows_sorted[:kb]  # the classic budgeted slice
    table1 = _gather_table(table_src, rows1)
    args = (row_offset, cfg, local_rows, row_stride)
    if train:
        rgb1, trans1, ckpt1, nproc1 = tile_raster_fwd_train(
            table1, pstarts_c, pcounts, *args)
    else:
        rgb1, trans1 = tile_raster_fwd(table1, pstarts_c, pcounts, *args)
        ckpt1 = nproc1 = None
    out = dict(table1=table1, pstarts_c=pstarts_c, pcounts=pcounts,
               ckpt1=ckpt1, nproc1=nproc1, rgb1=rgb1, trans1=trans1,
               ptrunc=ptrunc, rtrunc=torch.zeros_like(ptrunc), n=n)
    if k == 0:
        out.update(rgb=rgb1, trans=trans1)
        return out

    # ---- pass 2: the remaining rows of unfinished tiles, seeded by trans1
    finished = (trans1.amax(dim=1) <= cfg.early_stop_transmittance) \
        | (counts_full <= k)
    rc = torch.where(finished, torch.zeros_like(counts_full),
                     counts_full - k)
    rb = int(cfg.residual_budget_rows)
    rstarts = _exclusive(rc)
    rtrunc = (rstarts[num_tiles] - rb).clamp(min=0)
    rstarts_c = rstarts.clamp(max=rb)
    rcounts = (rstarts_c[1:] - rstarts_c[:-1]).to(i32)
    rstarts_c = rstarts_c.to(i32)
    rows2 = _ragged_rows(rstarts_c, starts_full[:-1] + k - rstarts_c[:-1],
                         rows_sorted, rb)
    table2 = _gather_table(table_src, rows2)
    res2 = tile_raster_fwd_seeded(table2, rstarts_c, rcounts, trans1, *args,
                                  train=train)
    if train:
        rgb2, trans2, ckpt2, nproc2 = res2
    else:
        (rgb2, trans2), ckpt2, nproc2 = res2, None, None
    out.update(table2=table2, rstarts_c=rstarts_c, rcounts=rcounts,
               ckpt2=ckpt2, nproc2=nproc2, rgb2=rgb2, rgb=rgb1 + rgb2,
               trans=trans2, rtrunc=rtrunc)
    return out


def probe_forward(splats, cfg: RenderConfig):
    """Autotune probe: one full-table train forward measuring what the
    fused path's budgets must cover.

    Returns (counts (T,), processed rows (T,), saturated (T,) bool,
    num_duplicates): per-tile list lengths, the rows the blend consumed
    before its early stop (window-granular) and whether the tile
    saturated.  ops/autotune.py turns these into the fused budgets."""
    with torch.no_grad():
        pres = binning.bin_splats_presort(splats, cfg)
        counts = pres.starts_full[1:] - pres.starts_full[:-1]
        # clear every fused budget: a re-tune of a fused config must probe
        # the FULL table, not a truncating prefix
        cfg0 = cfg.with_(prefix_rows=0, prefix_budget_rows=0,
                         residual_budget_rows=0, grad_budget_rows=0,
                         grad_residual_budget_rows=0)
        f = _forward(cfg0, cfg.tiles_y, 1, pres.table_src,
                     pres.rows_sorted, pres.starts_full, 0, train=True)
        nchunks = _num_chunks(f["pstarts_c"], f["pcounts"])
        processed = (torch.minimum(f["nproc1"].to(torch.int64), nchunks)
                     * KERNEL_CHUNK).to(torch.int32)
        sat = f["trans1"].amax(dim=1) <= cfg.early_stop_transmittance
    return counts, processed, sat, pres.num_duplicates


def _regions(starts_c, counts, nproc, budget: int, num_tiles: int):
    """Compact-gradient regions: an exclusive cumsum of each tile's
    processed windows.  Tiles whose region passes ``budget`` get nproc 0
    (their gradients are lost for the step).  Returns (clamped nproc (T,)
    i32, offsets goff (T,) i32, rows needed, rows dropped)."""
    np_eff = torch.minimum(nproc.to(torch.int64),
                           _num_chunks(starts_c, counts))
    sizes = np_eff * KERNEL_CHUNK
    goff = _exclusive(sizes)
    fits = goff[1:] <= budget
    dropped = torch.where(fits, torch.zeros_like(sizes), sizes).sum()
    return (torch.where(fits, np_eff, torch.zeros_like(np_eff)).to(
        torch.int32), goff[:-1].to(torch.int32), goff[num_tiles], dropped)


def _diag(*vals):
    return torch.stack([v.to(torch.float32) for v in vals])


class _BlendFused(torch.autograd.Function):
    """(table_src, rows_sorted, starts_full) -> (rgb, trans, diag);
    differentiable w.r.t. the packed table ``table_src`` only."""

    @staticmethod
    def forward(ctx, table_src, rows_sorted, starts_full, cfg, local_rows,
                row_stride, row_offset):
        f = _forward(cfg, local_rows, row_stride, table_src, rows_sorted,
                     starts_full, row_offset, train=True)
        num_tiles = local_rows * cfg.tiles_x
        g1_budget = _grad_budget(cfg, f["table1"].shape[1], num_tiles)
        np1, goff1, need, dropped = _regions(
            f["pstarts_c"], f["pcounts"], f["nproc1"], g1_budget, num_tiles)
        saved = [f["table1"], f["pstarts_c"], f["pcounts"], f["ckpt1"], np1,
                 goff1, f["trans1"], f["trans"]]
        g2_budget = 0
        if cfg.prefix_rows > 0:
            g2_budget = _grad_budget2(cfg, num_tiles)
            np2, goff2, need2, drop2 = _regions(
                f["rstarts_c"], f["rcounts"], f["nproc2"], g2_budget,
                num_tiles)
            need, dropped = need + need2, dropped + drop2
            saved += [f["table2"], f["rstarts_c"], f["rcounts"], f["ckpt2"],
                      np2, goff2, f["rgb2"]]
        diag = _diag(f["ptrunc"], f["rtrunc"], need, dropped)
        ctx.save_for_backward(*saved)
        ctx.args = (cfg, local_rows, row_stride, row_offset, f["n"],
                    g1_budget, g2_budget)
        ctx.mark_non_differentiable(diag)
        return f["rgb"], f["trans"], diag

    @staticmethod
    def backward(ctx, g_rgb, g_trans, _):
        cfg, local_rows, row_stride, row_offset, n, g1_budget, g2_budget = \
            ctx.args
        (table1, pstarts_c, pcounts, ckpt1, np1, goff1, trans1, trans,
         *pass2) = ctx.saved_tensors
        g_rgb = torch.zeros((*trans.shape, 3), dtype=trans.dtype,
                            device=trans.device) if g_rgb is None \
            else g_rgb.contiguous()
        g_trans = torch.zeros_like(trans) if g_trans is None \
            else g_trans.contiguous()
        band = (cfg, local_rows, row_stride)
        rows = []
        if pass2:
            table2, rstarts_c, rcounts, ckpt2, np2, goff2, rgb2 = pass2
            rows.append(tile_raster_bwd_fused(
                table2, rstarts_c, rcounts, np2, goff2, ckpt2, row_offset,
                g_rgb, g_trans, trans, torch.zeros_like(trans), trans1,
                g2_budget, *band))
            # pass-1 splats see the residual splats behind them
            suffix1 = (g_rgb * rgb2).sum(dim=-1)
        else:
            suffix1 = torch.zeros_like(trans)
        rows.insert(0, tile_raster_bwd_fused(
            table1, pstarts_c, pcounts, np1, goff1, ckpt1, row_offset,
            g_rgb, g_trans, trans, suffix1, torch.ones_like(trans),
            g1_budget, *band))
        g_all = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
        g_src = fold_rows_by_id(g_all, n, bool(cfg.grad_fold_bf16))
        return g_src, None, None, None, None, None, None


def blend_fused(cfg: RenderConfig, local_rows: int, row_stride: int,
                table_src: torch.Tensor, rows_sorted: torch.Tensor,
                starts_full: torch.Tensor, row_offset: int = 0):
    """-> (rgb tiles (T, P, 3), trans tiles (T, P), diag (4,) f32).

    diag = [prefix_trunc, residual_trunc, grad_rows_needed,
    grad_rows_dropped]; the gradient entries are filled only under autograd
    with a table that requires grad (an inference forward, B1 + B4 without
    residuals, reports 0).  Differentiable w.r.t. ``table_src`` only."""
    # grad mode is off inside Function.forward, so the forward's kernels
    # are chosen here
    if torch.is_grad_enabled() and table_src.requires_grad:
        if table_src.device.type == "cuda":
            # B4 train and B5 take 16 only: refuse before pass 1 launches B2
            check_tile_size(cfg, fused_train=True)
        return _BlendFused.apply(table_src, rows_sorted, starts_full, cfg,
                                 local_rows, row_stride, row_offset)
    f = _forward(cfg, local_rows, row_stride, table_src, rows_sorted,
                 starts_full, row_offset, train=False)
    zero = torch.zeros_like(f["ptrunc"])
    return f["rgb"], f["trans"], _diag(f["ptrunc"], f["rtrunc"], zero, zero)
