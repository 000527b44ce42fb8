"""Tile binning: duplicate splats into (tile, depth)-ordered contiguous
lists and materialize the attribute-major splat table; its gradient folds
the table's per-row gradients back onto the splats.

The JAX package bins with a scatter-free tiered pool ladder because TPU
scatters are slow.  Here the pipeline is exact and sized by the live
duplicate count:

  1. per-splat tile bbox (``tile_bbox``, same clamps as JAX);
  2. count -> exclusive scan -> expand (``repeat_interleave``) gives one
     candidate per (splat, bbox tile); tight culling drops the candidates
     whose best pixel alpha is below alpha_min (same formulas as JAX;
     surfels keep every candidate, the blend kernels cull them exactly);
  3. ONE ``torch.sort`` over an int64 key (fused 32-bit (tile | depth)
     key << id_bits) | splat id — the JAX order: tile id high, the top
     ``depth_bits`` of the positive-f32 depth pattern next, the splat id as
     the secondary key.  ``depth_bits`` is sized by the whole image's tile
     count, also for a band of rows (JAX sizes it by the band's), so a
     band's lists are exactly the image's lists of those rows;
  4. ``searchsorted`` tile starts, the table budget and ``truncated``,
     and one row gather into the (16, cap + TABLE_PAD) table.

``bin_splats_presort`` stops before step 4's budget and gather: the fused
path (ops/fused.py) gathers per-tile row prefixes itself.

Only the gather is differentiable (``_GatherTableRows``, the counterpart of
the JAX ``_gather_table_rows`` custom_vjp): its backward keeps the first
GRAD_WIDTH table columns, rounds them to bf16 when ``cfg.grad_fold_bf16``
(JAX's semantics), and folds rows onto splats with one gather of each
splat's rows (their table columns in splat-major order, known from the
sort) and one segment sum per splat (``fold_table_grad``), which gives the
same bits on every run; an ``index_add_`` would add in the order its
atomics land.  The JAX pool ladder, payload sort and tier routing
are TPU devices and are not ported.  Steps 1-3 run on detached values.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats
from gaussiansplattingviewer_tpu_torch.utils import profiling

# Row layout of the packed splat table (lane-padded to 16 floats):
# [cx, cy, conic_a, conic_b, conic_c, r, g, b, opacity, rx, ry, depth,
#  x0, y0, w, count] — columns 12-15 are never read by the blend.
TABLE_WIDTH = 16
COL_CX, COL_CY = 0, 1
COL_A, COL_B, COL_C = 2, 3, 4
COL_R, COL_G, COL_BCH = 5, 6, 7
COL_OPACITY = 8
COL_RX, COL_RY = 9, 10
COL_DEPTH = 11
COL_X0, COL_Y0, COL_W, COL_COUNT = 12, 13, 14, 15
# columns cx .. opacity: the only ones the blend differentiates
GRAD_WIDTH = COL_OPACITY + 1
# A surfel (2DGS) row in the same 16 columns: the rows Tu, Tv, Tw of its
# homography in place of the conic, the rect and the depth:
# [cx, cy, Tu0, Tu1, Tu2, r, g, b, opacity, Tv0, Tv1, Tv2, Tw0, Tw1, Tw2,
#  count] — cx, cy the centre of its 3-sigma ellipse (the low-pass's)
COL_TU, COL_TV, COL_TW = 2, 9, 12
# table rows the blend reads: cx .. ry (3DGS), cx .. Tw2 (surfels)
BLEND_ATTRS = COL_RY + 1
SURFEL_ATTRS = COL_TW + 3

# the blend reads 256-row windows aligned to 128 rows around each segment
SEGMENT_ALIGN = 128
KERNEL_CHUNK = 256
TABLE_PAD = 2 * KERNEL_CHUNK

# float -> int conversions of out-of-range values are undefined in torch;
# values beyond this bound are clipped to the tile grid anyway
_INT_SAFE = float(2 ** 30)


@dataclasses.dataclass
class BinnedSplats:
    """Contiguous, depth-ordered per-tile splat lists.

    table: attribute-major (TABLE_WIDTH, cap + TABLE_PAD) f32; tile t's rows
      are columns [tile_starts[t], tile_starts[t+1]); cap = min(live
      duplicates, table budget).
    tile_starts: (num_tiles + 1,) i32.  tile_counts: (num_tiles,) i32.
    num_duplicates: () i32 — rows materialized.
    overflow: () i32 — splats clamped by ``max_tiles_per_gaussian``.
    truncated: () i32 — duplicates dropped by the table budget.
    surfel: the rows are surfel rows (``pack_table``).
    """

    table: torch.Tensor
    tile_starts: torch.Tensor
    tile_counts: torch.Tensor
    num_duplicates: torch.Tensor
    overflow: torch.Tensor
    truncated: torch.Tensor
    surfel: bool = False


def _to_int(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -_INT_SAFE, _INT_SAFE).to(torch.int32)


def tile_bbox(splats: ProjectedSplats, cfg: RenderConfig, ty_lo: int = 0,
              ty_hi: int | None = None, row_stride: int = 1):
    """Per-splat tile bbox clamped to the grid, to the static duplicate cap
    and to the shard's tile-row set {ty_lo + s * row_stride} < ty_hi.

    Returns (x0, y0_local, w, h, count, overflowed), int32 (N,) each.
    """
    ts = float(cfg.tile_size)
    tx_n, ty_n = cfg.tiles_x, cfg.tiles_y
    if ty_hi is None:
        ty_hi = ty_n
    cx, cy = splats.mean2d[:, 0], splats.mean2d[:, 1]
    rx, ry = splats.radius[:, 0], splats.radius[:, 1]

    x0 = _to_int(torch.floor((cx - rx) / ts))
    x1 = _to_int(torch.floor((cx + rx) / ts))
    y0 = _to_int(torch.floor((cy - ry) / ts))
    y1 = _to_int(torch.floor((cy + ry) / ts))

    # clip to the GLOBAL grid first so the cap below is band-invariant
    onscreen = (x1 >= 0) & (x0 < tx_n) & (y1 >= 0) & (y0 < ty_n)
    x0 = torch.clamp(x0, 0, tx_n - 1)
    x1 = torch.clamp(x1, 0, tx_n - 1)
    y0 = torch.clamp(y0, 0, ty_n - 1)
    y1 = torch.clamp(y1, 0, ty_n - 1)
    w = x1 - x0 + 1
    h = y1 - y0 + 1

    # optional static cap: shrink the span around the splat's own tile
    kmax = cfg.max_tiles_per_gaussian if cfg.max_tiles_per_gaussian > 0 \
        else tx_n * ty_n
    overflowed = (w * h) > kmax
    w_c = torch.clamp(w, max=kmax)
    h_c = torch.minimum(h, torch.clamp(kmax // torch.clamp(w_c, min=1), min=1))
    ctx = torch.clamp(_to_int(cx / ts), 0, tx_n - 1)
    cty = torch.clamp(_to_int(cy / ts), 0, ty_n - 1)
    x0 = torch.where(
        overflowed, torch.minimum(torch.clamp(ctx - w_c // 2, min=0),
                                  tx_n - w_c), x0)
    y0 = torch.where(
        overflowed, torch.minimum(torch.clamp(cty - h_c // 2, min=0),
                                  ty_n - h_c), y0)
    w = torch.where(overflowed, w_c, w)
    y1 = torch.where(overflowed, y0 + h_c - 1, y1)

    # intersect with the shard's row set
    if row_stride == 1:
        y0b = torch.clamp(y0, min=ty_lo)
        y1b = torch.clamp(y1, max=ty_hi - 1)
        s0 = y0b - ty_lo
        h = y1b - y0b + 1
    else:
        lo = torch.clamp(y0 - ty_lo, min=0)
        hi = torch.clamp(y1, max=ty_hi - 1) - ty_lo
        s0 = (lo + (row_stride - 1)) // row_stride
        s1 = torch.clamp(hi, min=0) // row_stride
        s1 = torch.where(hi < 0, torch.full_like(s1, -1), s1)
        h = s1 - s0 + 1
    in_band = h > 0

    live = splats.valid & onscreen & in_band
    count = torch.where(live, w * h, torch.zeros_like(w))
    return x0, s0, w, torch.clamp(h, min=0), count, overflowed & live


def pack_table(splats: ProjectedSplats) -> torch.Tensor:
    """Per-splat render attributes as (N, TABLE_WIDTH) f32 rows
    (differentiable; surfels in the surfel layout).  While recording,
    their gradient opens span ``project_bwd``."""
    zero = torch.zeros_like(splats.depth)
    head = [splats.mean2d[:, 0], splats.mean2d[:, 1]]
    shade = [splats.color[:, 0], splats.color[:, 1], splats.color[:, 2],
             torch.where(splats.valid, splats.opacity, zero)]
    if splats.surfel:
        t = splats.transform
        cols = head + [t[:, k] for k in range(3)] + shade \
            + [t[:, k] for k in range(3, 9)] + [zero]
    else:
        cols = head + [splats.conic[:, k] for k in range(3)] + shade + [
            splats.radius[:, 0], splats.radius[:, 1], splats.depth,
            zero, zero, zero, zero]
    table = torch.stack(cols, dim=1).to(torch.float32)
    if profiling.recording():
        (table,) = profiling.open_in_backward("project_bwd", (table,),
                                              table.device)
    return table


def fold_table_grad(g: torch.Tensor, pos: torch.Tensor,
                    offsets: torch.Tensor, cap: int,
                    fold_bf16: bool) -> torch.Tensor:
    """The gradient fold: the (n, TABLE_WIDTH) gradient of the packed rows
    from the table's gradient ``g`` (TABLE_WIDTH, >= cap).

    ``pos`` (M,) is the table column of each duplicate in splat-major
    order, splat i's duplicates being [offsets[i], offsets[i + 1]); columns
    at or past ``cap`` were truncated and carry no gradient.  Only columns
    0..GRAD_WIDTH-1 of the table carry gradient, rounded to bf16 first with
    ``fold_bf16``.  The columns are turned into (cap, GRAD_WIDTH) rows, one
    row gather puts each splat's rows together (a duplicate past ``cap``
    takes an appended zero row) and one segment sum per splat adds them in
    f32, in the same order on every run: no atomics (the counterpart of
    the JAX fold's sort by ``perm`` and fixed-shape sums)."""
    rows = torch.cat([g[:GRAD_WIDTH, :cap].T,
                      g.new_zeros((1, GRAD_WIDTH))])
    if fold_bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    rows = rows.index_select(0, torch.clamp(pos, max=cap))
    sums = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                                unsafe=True)
    return torch.nn.functional.pad(sums, (0, TABLE_WIDTH - GRAD_WIDTH))


class _GatherTableRows(torch.autograd.Function):
    """packed (N, 16) rows -> the (16, cap + TABLE_PAD) table, column j the
    row sid[j] (j < cap); the backward is the gradient fold
    (``fold_table_grad``) over the duplicates' table columns ``pos`` in
    splat-major order."""

    @staticmethod
    def forward(ctx, packed, sid, pos, offsets, width, fold_bf16):
        ctx.request = profiling.request()
        cap = sid.shape[0]
        table = torch.zeros((TABLE_WIDTH, width), dtype=torch.float32,
                            device=packed.device)
        table[:, :cap] = packed[sid].T
        ctx.save_for_backward(pos, offsets)
        ctx.cap = cap
        ctx.fold_bf16 = fold_bf16
        return table

    @staticmethod
    def backward(ctx, g):
        pos, offsets = ctx.saved_tensors
        with profiling.span("fold", g.device, request=ctx.request):
            g_packed = fold_table_grad(g, pos, offsets, ctx.cap,
                                       ctx.fold_bf16)
        return g_packed, None, None, None, None, None


def _tight_live(splats: ProjectedSplats, cfg: RenderConfig, sid, tx_i, ty_i,
                row_offset: int, row_stride: int) -> torch.Tensor:
    """Exact per-tile alpha test of candidates (splat ``sid``, tile
    (tx_i, ty_i)): keep iff the minimum over the tile's pixel-centre rect of
    f = A dx^2 + 2B dx dy + C dy^2 is at most 2 (ln op - ln alpha_min), i.e.
    some pixel can reach alpha_min.  Valid for positive-definite conics,
    which projection guarantees (it inverts cov2d + 0.3 I)."""
    log_alpha_min = math.log(cfg.alpha_min)
    op = torch.where(splats.valid, splats.opacity,
                     torch.zeros_like(splats.opacity))
    # log in f64, rounded: the correctly rounded f32 log on any CPU thread
    # partition (see raster_oracle.fragment_exp)
    log_op = torch.log(torch.clamp(op, min=1e-20).double()).float()
    thr = (2.0 * (log_op - log_alpha_min))[sid]
    ca = torch.clamp(splats.conic[:, 0], min=1e-12)
    cc = torch.clamp(splats.conic[:, 2], min=1e-12)
    cb = splats.conic[:, 1]
    rbc = (cb / cc)[sid]
    rba = (cb / ca)[sid]
    va, vb, vc = ca[sid], cb[sid], cc[sid]
    ts = float(cfg.tile_size)
    xlo = tx_i.to(torch.float32) * ts + 0.5 - splats.mean2d[sid, 0]
    gy = row_offset + ty_i * row_stride  # global tile row
    ylo = gy.to(torch.float32) * ts + 0.5 - splats.mean2d[sid, 1]
    xhi = xlo + (ts - 1.0)
    yhi = ylo + (ts - 1.0)

    def edge_x(ex):  # min of f over the edge dx = ex
        dy = torch.minimum(torch.maximum(-rbc * ex, ylo), yhi)
        return ex * (va * ex + 2.0 * vb * dy) + vc * dy * dy

    def edge_y(ey):
        dx = torch.minimum(torch.maximum(-rba * ey, xlo), xhi)
        return dx * (va * dx + 2.0 * vb * ey) + vc * ey * ey

    f_min = torch.minimum(
        torch.minimum(edge_x(xlo), edge_x(xhi)),
        torch.minimum(edge_y(ylo), edge_y(yhi)),
    )
    inside = (xlo <= 0.0) & (xhi >= 0.0) & (ylo <= 0.0) & (yhi >= 0.0)
    f_min = torch.where(inside, torch.zeros_like(f_min), f_min)
    return f_min <= thr


@dataclasses.dataclass
class PresortedBins:
    """``bin_splats`` minus the table gather: the fused path's input
    (ops/fused.py gathers per-tile row prefixes itself).

    table_src: (N, TABLE_WIDTH) f32 ``pack_table`` rows (differentiable).
    rows_sorted: (live duplicates,) int64 splat id of every sorted row, in
      (tile | depth | id) order; only live rows (JAX pads to the slot
      capacity with dead slots past the last tile).
    starts_full: (num_tiles + 1,) i32 UNCLIPPED segment boundaries into
      rows_sorted (the fused path applies its own budgets).
    num_duplicates: () i32 live duplicates.  overflow, surfel: as in
    BinnedSplats.
    """

    table_src: torch.Tensor
    rows_sorted: torch.Tensor
    starts_full: torch.Tensor
    num_duplicates: torch.Tensor
    overflow: torch.Tensor
    surfel: bool = False


def _sorted_rows(splats: ProjectedSplats, cfg: RenderConfig, row_offset: int,
                 local_rows: int | None, row_stride: int):
    """Candidates -> tight cull -> (tile | depth | id) sort, on detached
    values.  Returns (sorted splat ids (M,) int64, unclipped tile starts
    (T + 1,) int64, overflow () i32, pos, offsets): the candidates are made
    splat by splat, so ``pos`` (M,) int64, the sorted position of each
    candidate, lists each splat's table rows together, splat i's at
    [offsets[i], offsets[i + 1]) (offsets (N + 1,) int64)."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    splats = ProjectedSplats(**{
        f.name: None if getattr(splats, f.name) is None
        else getattr(splats, f.name).detach()
        for f in dataclasses.fields(splats)})
    dev = splats.depth.device
    n = splats.depth.shape[0]
    num_tiles = local_rows * cfg.tiles_x
    ty_hi = (row_offset + local_rows if row_stride == 1
             else row_offset + (local_rows - 1) * row_stride + 1)
    x0, y0, w, _, count, overflowed = tile_bbox(
        splats, cfg, ty_lo=row_offset, ty_hi=ty_hi, row_stride=row_stride)

    # ---- candidates: one per (splat, bbox tile), row-major in the bbox
    count64 = count.to(torch.int64)
    sid = torch.repeat_interleave(
        torch.arange(n, device=dev), count64)
    first = torch.cumsum(count64, 0) - count64  # exclusive scan
    kk = torch.arange(sid.shape[0], device=dev) - first[sid]
    profiling.count("bin.candidates", sid.shape[0])
    w_s = torch.clamp(w, min=1).to(torch.int64)[sid]
    tx_i = x0.to(torch.int64)[sid] + kk % w_s
    ty_i = y0.to(torch.int64)[sid] + kk // w_s
    # surfels keep their rects: the kernels' band cull is exact, and a
    # per-candidate surfel test cost more than the pairs it dropped
    if cfg.tight_culling and int(cfg.mode) != int(RenderMode.BILLBOARD) \
            and not splats.surfel:
        keep = _tight_live(splats, cfg, sid, tx_i, ty_i, row_offset,
                           row_stride)
        sid, tx_i, ty_i = sid[keep], tx_i[keep], ty_i[keep]
    profiling.count("bin.pairs", sid.shape[0])
    tiles = ty_i * cfg.tiles_x + tx_i

    # ---- fused (tile | depth) key, splat id as the secondary key
    # the depth field's width follows the whole image's tile count, not
    # the band's: a band's rows then sort exactly as in the single render,
    # so a sharded render reproduces it bit for bit (the JAX package sizes
    # it by the band, whose finer depth order can swap near-equal depths)
    depth_bits = 32 - int(max(num_tiles, cfg.num_tiles) + 1).bit_length()
    id_bits = max(int(n - 1).bit_length(), 1)
    if 32 + id_bits > 63:
        raise ValueError(f"{n} splats do not fit the int64 sort key")
    dbits = torch.clamp(splats.depth.to(torch.float32), min=0.0).view(
        torch.int32).to(torch.int64) & 0xFFFFFFFF  # the u32 bit pattern
    dq = dbits >> (32 - depth_bits)
    fused = (tiles << depth_bits) | dq[sid]
    key = (fused << id_bits) | sid
    key_sorted, order = torch.sort(key)
    sid_sorted = key_sorted & ((1 << id_bits) - 1)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=dev)
    offsets = torch.searchsorted(sid, torch.arange(n + 1, device=dev))

    bounds = (torch.arange(num_tiles + 1, device=dev, dtype=torch.int64)
              << (depth_bits + id_bits))
    starts = torch.searchsorted(key_sorted, bounds)
    return sid_sorted, starts, overflowed.sum().to(torch.int32), pos, offsets


def bin_splats_presort(splats: ProjectedSplats, cfg: RenderConfig,
                       row_offset: int = 0, local_rows: int | None = None,
                       row_stride: int = 1) -> PresortedBins:
    """Duplicate expansion and the fused (tile | depth) sort without the
    table gather (the port of the JAX ``bin_splats_presort``).  Span
    ``bin``."""
    with profiling.span("bin", splats.depth.device):
        sid_sorted, starts, overflow, _, _ = _sorted_rows(
            splats, cfg, row_offset, local_rows, row_stride)
        return PresortedBins(
            table_src=pack_table(splats),
            rows_sorted=sid_sorted,
            starts_full=starts.to(torch.int32),
            num_duplicates=torch.tensor(int(sid_sorted.shape[0]),
                                        dtype=torch.int32,
                                        device=sid_sorted.device),
            overflow=overflow,
            surfel=splats.surfel,
        )


def bin_splats(splats: ProjectedSplats, cfg: RenderConfig,
               row_offset: int = 0, local_rows: int | None = None,
               row_stride: int = 1) -> BinnedSplats:
    """Depth-ordered per-tile lists over the shard's ``local_rows`` global
    tile rows {row_offset + s * row_stride}; defaults cover the image.
    Span ``bin``."""
    with profiling.span("bin", splats.depth.device):
        return _bin_splats(splats, cfg, row_offset, local_rows, row_stride)


def _bin_splats(splats, cfg, row_offset, local_rows, row_stride):
    packed = pack_table(splats)
    sid_sorted, starts, overflow, pos, offsets = _sorted_rows(
        splats, cfg, row_offset, local_rows, row_stride)
    n = packed.shape[0]
    total = int(sid_sorted.shape[0])

    # ---- budgeted table
    budget = cfg.table_budget_rows or cfg.table_budget_factor * n
    cap = min(total, budget)
    starts = torch.clamp(starts, max=cap).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    if splats.surfel and packed.requires_grad:
        # the fold takes 3DGS columns: autograd gathers surfel rows (CPU)
        table = torch.nn.functional.pad(packed[sid_sorted[:cap]].T,
                                        (0, TABLE_PAD))
    else:
        table = _GatherTableRows.apply(packed, sid_sorted[:cap], pos,
                                       offsets, cap + TABLE_PAD,
                                       bool(cfg.grad_fold_bf16))
    i32 = dict(dtype=torch.int32, device=packed.device)
    return BinnedSplats(
        table=table,
        tile_starts=starts,
        tile_counts=counts,
        num_duplicates=torch.tensor(cap, **i32),
        overflow=overflow,
        truncated=torch.tensor(max(total - budget, 0), **i32),
        surfel=splats.surfel,
    )
