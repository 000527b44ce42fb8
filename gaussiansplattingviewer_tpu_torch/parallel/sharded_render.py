"""Tile-row-sharded rendering and training on ``torch.distributed`` (the
port of the JAX package's ``parallel/sharded_render.py``).

Each rank renders one set of tile rows of the image: the contiguous band
{idx * rows + s} or, interleaved, the rows {idx + s * n}.  The tile-row
count is padded to a multiple of the world size; padded rows render
background and are cropped off.  On CUDA tensors a band runs kernels B1
(or B2 and B3 under autograd) on its own table, or with ``use_kernel=False``
the tile executor (ops/blend.py), as JAX's bodies take ``use_pallas``.

  * replicated (default): every rank holds the whole scene, projects it,
    compacts the splats that touch its band (``band_budget_factor``) or
    pre-culls the raw scene before projection (``precull_budget_factor``),
    then bins and blends its band.  A replicated scene's gradient on each
    rank is its band's share; one all-reduce sums them
    (``all_reduce_grads``).
  * ``shard_splats``: each rank holds N / world splats, projects them,
    optionally compacts the frustum survivors (``gather_budget_factor``),
    and all-gathers the packed splats; the gather's backward is a
    reduce-scatter, so each rank's shard gets its whole gradient.
  * ``exchange`` (with ``shard_splats``): each rank partitions its
    projected splats by destination band (``_exchange_parts``: one stable
    sort by (destination, id)) and one all-to-all delivers each rank the
    splats touching its rows; the backward is the reverse all-to-all and
    the gather's sort-based fold.

``make_sharded_render_fn`` returns the cropped (H, W, 3) image on every
rank.  Its image gather assumes that every rank holds the same loss of
that image: its backward keeps each rank's own rows of the cotangent.
``_render_band`` takes a concrete ``idx``, so one process can run any
shard's exact program.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
from gaussiansplattingviewer_tpu_torch.ops.compaction import (
    compact_by_mask,
    compact_splats,
    pack_splats,
    unpack_splats,
)
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.parallel.mesh import Mesh

_EXCHANGE_DENSE_SLOTS = 4  # destinations covered without the pool
_WIRE_COLS = binning.COL_DEPTH + 1  # packed columns a splat needs (12)


def _rows_per_shard(cfg: RenderConfig, n_shards: int) -> int:
    return -(-cfg.tiles_y // n_shards)


def _round_budget(b: int, n: int) -> int:
    return min(n, max(-(-b // 1024) * 1024, 4096))


# ---- collectives with autograd (equal shares, dim 0, rank order)

def _all_gather(out, x, group):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x.contiguous(), group=group)
    return out


def _reduce_scatter(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Every rank's x stacked along dim 0; the backward reduce-scatters
    (sums) the cotangent, each rank receiving its own rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world = dist.get_world_size(group)
        return _all_gather(x.new_empty((world * x.shape[0], *x.shape[1:])),
                           x, group)

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // world, *g.shape[1:]))
        return _reduce_scatter(out, g, ctx.group), None


class _GatherImage(torch.autograd.Function):
    """Every rank's band image stacked (world, ...); every rank holds the
    same loss of the result, so the backward keeps this rank's own slice
    of the cotangent."""

    @staticmethod
    def forward(ctx, band, group):
        ctx.rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        out = band.new_empty((world, *band.shape))
        _all_gather(out.view(world * band.shape[0], *band.shape[1:]), band,
                    group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank].contiguous(), None


class _AllToAll(torch.autograd.Function):
    """Slice s of dim 0 goes to rank s; rank s's slice for this rank
    arrives at slice s.  Its transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_gather_mask(mask, group):
    world = dist.get_world_size(group)
    out = torch.empty((world * mask.shape[0],), dtype=torch.uint8,
                      device=mask.device)
    return _all_gather(out, mask.to(torch.uint8), group).bool()


def _all_to_all_mask(mask, group):
    out = torch.empty(mask.shape, dtype=torch.uint8, device=mask.device)
    dist.all_to_all_single(out, mask.to(torch.uint8).contiguous(),
                           group=group)
    return out.bool()


# ---- exchange mode

class _ExchangeGather(torch.autograd.Function):
    """pack12[ids_take]: the (n_shards, budget, 12) rows each destination
    gets.  The backward folds them onto the n_loc source splats with the
    JAX fold's steps, so every run adds in the same order: position p of
    the (destination, id) order was taken iff its rank in its destination
    is below the budget; one gather puts the taken gradients in that
    order, ``perm`` (a permutation) puts them back in slot order, and
    fixed-shape sums add each splat's dense slots and route its pool
    slots."""

    @staticmethod
    def forward(ctx, pack12, ids_take, perm, key_sorted, starts, pool_pos,
                levels):
        ctx.save_for_backward(perm, key_sorted, starts, pool_pos)
        ctx.levels = levels
        return pack12[ids_take]

    @staticmethod
    def backward(ctx, g):
        k_d, n_loc, kx, cap_pool, budget, n_shards = ctx.levels
        perm, key_sorted, starts, pool_pos = ctx.saved_tensors
        cap = perm.shape[0]
        width = g.shape[-1]
        pos = torch.arange(cap, device=g.device)
        dest = torch.clamp(key_sorted, max=n_shards)
        rank = pos - starts[torch.clamp(dest, max=n_shards - 1)]
        taken = (dest < n_shards) & (rank < budget)
        g_flat = torch.cat([g.reshape(n_shards * budget, width),
                            g.new_zeros((1, width))])
        idx = torch.where(taken, dest * budget + rank,
                          torch.full_like(dest, n_shards * budget))
        g_by_flat = g.new_empty((cap, width))
        g_by_flat[perm] = g_flat[idx]
        g1 = g_by_flat[: n_loc * k_d].reshape(k_d, n_loc, width).sum(dim=0)
        if kx > 0 and cap_pool > 0:
            gp = g_by_flat[n_loc * k_d:].reshape(kx, cap_pool, width).sum(
                dim=0)
            gp = torch.cat([gp, g.new_zeros((1, width))])
            g1 = g1 + gp[torch.clamp(pool_pos, max=cap_pool)]
        return g1, None, None, None, None, None, None


def _exchange_parts(splats, cfg: RenderConfig, rows: int, n_shards: int,
                    exchange_budget_factor: float, row_stride: int = 1):
    """Send side of exchange mode: partition this rank's projected splats
    by the rank that owns each tile row they touch.  Returns (rows
    (n_shards, budget, 12) f32, valid (n_shards, budget) bool, dropped ()
    int64): one all-to-all away from every rank holding exactly the splats
    touching its rows.

    row_stride 1: rank d owns the band [d * rows, (d + 1) * rows);
    row_stride n_shards: rank d owns the rows {d + s * n_shards}.  A splat
    goes to rank d iff its tile-row span [y0, y1] holds a row rank d owns.

    Each splat gets ``k_d`` dense destination slots (its j-th destination
    band); splats spanning more bands take a pool entry (n_shards - k_d
    more slots) through one stable partition.  One sort by (destination,
    splat id) orders all slots (unused slots sort last), and the segment
    starts turn them into the fixed-shape all-to-all operand with one row
    gather (``_ExchangeGather``)."""
    n_loc = splats.valid.shape[0]
    dev = splats.valid.device
    _, y0g, _, hh, cnt, _ = binning.tile_bbox(splats, cfg)
    y0g, hh = y0g.to(torch.int64), hh.to(torch.int64)
    live = cnt > 0
    frac = min(1.0, rows / cfg.tiles_y * exchange_budget_factor)
    budget = _round_budget(int(n_loc * frac), n_loc)
    sent = n_shards
    zero = torch.zeros_like(y0g)

    if row_stride == 1:
        d0 = torch.clamp(y0g // rows, 0, n_shards - 1)
        d1 = torch.clamp((y0g + hh - 1) // rows, 0, n_shards - 1)
        nd = torch.where(live, d1 - d0 + 1, zero)

        def dest_j(j):
            return d0 + j
    else:
        if row_stride != n_shards:
            raise ValueError("exchange takes contiguous or interleaved rows")
        nd = torch.where(live, torch.clamp(hh, max=n_shards), zero)
        y0m = torch.remainder(y0g, n_shards)

        def dest_j(j):
            d = y0m + j
            return torch.where(d >= n_shards, d - n_shards, d)

    k_d = min(_EXCHANGE_DENSE_SLOTS, n_shards)
    kx = n_shards - k_d
    ids = torch.arange(n_loc, device=dev)
    if kx > 0:
        # stable partition: splats spanning > k_d bands claim a pool entry
        need = nd > k_d
        sel = torch.sort((~need).to(torch.int32), stable=True)[1]
        pos = torch.empty_like(sel)
        pos[sel] = ids
        cap_pool = min(n_loc, max(n_loc // 8, 512))
        in_pool = need & (pos < cap_pool)
        dropped_pool = (need & ~in_pool).sum()
        pool_ids = sel[:cap_pool]
        pool_pos = torch.where(in_pool, pos, torch.full_like(pos, cap_pool))
    else:
        cap_pool = 0
        dropped_pool = torch.zeros((), dtype=torch.int64, device=dev)
        pool_pos = torch.zeros((n_loc,), dtype=torch.int64, device=dev)

    # slot-major keys: dense slot j covers dest_j of every splat, pool slot
    # j covers dest_{k_d + j} of the pool entries
    jj = torch.arange(k_d, device=dev)[:, None]
    keys = [torch.where(jj < nd[None, :], dest_j(jj),
                        torch.full_like(jj, sent)).reshape(-1)]
    src = [ids.expand(k_d, n_loc).reshape(-1)]
    if kx > 0 and cap_pool > 0:
        jj = torch.arange(kx, device=dev)[:, None] + k_d
        nd_p = nd[pool_ids][None, :]
        if row_stride == 1:
            dpj = d0[pool_ids][None, :] + jj
        else:
            dpj = torch.remainder(y0g[pool_ids], n_shards)[None, :] + jj
            dpj = torch.where(dpj >= n_shards, dpj - n_shards, dpj)
        keys.append(torch.where(jj < nd_p, dpj,
                                torch.full_like(dpj, sent)).reshape(-1))
        src.append(pool_ids.expand(kx, cap_pool).reshape(-1))
    keys, src = torch.cat(keys), torch.cat(src)
    cap = keys.shape[0]

    # (dest, splat id) pairs are unique: one total order, each
    # destination's splats in id order
    key_sorted, perm = torch.sort(keys * n_loc + src)
    src_sorted = key_sorted % n_loc
    key_sorted = key_sorted // n_loc
    starts = torch.searchsorted(
        key_sorted, torch.arange(n_shards + 1, device=dev), side="left")
    seg_len = starts[1:] - starts[:-1]
    dropped = torch.clamp(seg_len - budget, min=0).sum() + dropped_pool

    jgrid = torch.arange(budget, device=dev)[None, :]
    posmat = starts[:-1, None] + jgrid  # (n_shards, budget)
    valid_take = jgrid < seg_len[:, None]
    ids_take = src_sorted[torch.clamp(posmat, max=cap - 1)]

    pack12 = pack_splats(splats)[0][:, :_WIRE_COLS]
    rows12 = _ExchangeGather.apply(
        pack12, ids_take, perm, key_sorted, starts, pool_pos,
        (k_d, n_loc, kx, cap_pool, budget, n_shards))
    # a row is live on the receiver iff it was a real segment entry AND its
    # source splat was valid
    valid = valid_take & splats.valid[ids_take]
    return rows12, valid, dropped


def _splats_from_received(rows_rx, valid_rx):
    """Packed 12-column rows (as sent) -> ProjectedSplats."""
    rows_rx = torch.cat([rows_rx, rows_rx.new_zeros(
        (rows_rx.shape[0], binning.TABLE_WIDTH - rows_rx.shape[1]))], dim=1)
    return unpack_splats(rows_rx, valid_rx)


# ---- the band pre-cull

def band_precull_mask(scene: GaussianData, view, proj, cfg: RenderConfig,
                      ty_lo: int, ty_hi: int, row_stride: int = 1):
    """Cheap conservative test, before projection: can this splat's
    footprint touch the tile rows {ty_lo + s * row_stride} in [ty_lo,
    ty_hi)?  One elementwise pass: the view transform and an upper bound
    of the y radius from the largest scale axis.

    Conservative by construction: the y radius is bounded through
    |T_row| * s_max >= sqrt(cov_yy), the NDC cull uses the exact limit plus
    a margin, and both are inflated 1%; splats it keeps that the exact path
    culls are culled again later, so a sharded render stays bit-exact.  The
    same f32 expressions as the JAX mask, which this one equals bit for
    bit."""
    f32 = torch.float32
    dev = scene.xyz.device
    xyz = scene.xyz.detach().to(f32)
    view = torch.as_tensor(view, dtype=f32, device=dev)
    proj = torch.as_tensor(proj, dtype=f32, device=dev)
    mean_view = xyz @ view[:3, :3].T + view[:3, 3]
    n = xyz.shape[0]
    clip = torch.cat([mean_view, torch.ones((n, 1), dtype=f32, device=dev)],
                     dim=-1) @ proj.T
    w = clip[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[..., :3] / w_safe[..., None]
    lim = cfg.ndc_cull_limit * 1.001 + 1e-5
    maybe_visible = torch.all(torch.abs(ndc) <= lim, dim=-1) & (w > 0.0)
    maybe_visible &= scene.opacity.detach()[..., 0] > 0.0

    # y-radius bound 3 sqrt(|t1|^2 s_max^2 + 0.3), |t1| <= (focal / |tz|)
    # (1 + 1.3 tanfovy) (the fov clamp's worst case)
    scale_mult = cfg.scale_modifier * (
        cfg.depth_scale_inflate if int(cfg.mode) == RenderMode.DEPTH
        else 1.0)
    s_max = torch.amax(scene.scale.detach().to(f32), dim=-1) * scale_mult
    htany = 1.0 / proj[1, 1]
    focal = cfg.height / (2.0 * htany)
    tz = torch.clamp(torch.abs(mean_view[..., 2]), min=1e-8)
    t1 = focal / tz * (1.0 + 1.3 * htany)
    ts1 = t1 * s_max
    ry = 3.0 * torch.sqrt(ts1 * ts1 + 0.3) * 1.01 + 0.5

    py = (1.0 - ndc[..., 1]) * 0.5 * cfg.height
    ts = float(cfg.tile_size)
    y0 = binning._to_int(torch.floor((py - ry) / ts))
    y1 = binning._to_int(torch.floor((py + ry) / ts))
    if row_stride == 1:
        in_band = (y1 >= ty_lo) & (y0 <= ty_hi - 1)
    else:
        lo = torch.clamp(y0 - ty_lo, min=0)
        hi = torch.clamp(y1, max=ty_hi - 1) - ty_lo
        s0 = (lo + (row_stride - 1)) // row_stride
        s1 = torch.where(hi >= 0, hi // row_stride, torch.full_like(hi, -1))
        in_band = (y1 >= 0) & (s1 >= s0)
    return maybe_visible & in_band


# ---- the band body

def _band_top(rows: int, row0: int, row_stride: int) -> int:
    """The tile row past the last of the row set."""
    return row0 + rows if row_stride == 1 \
        else row0 + (rows - 1) * row_stride + 1


def _render_band(scene: GaussianData, view, proj, cam_pos, cfg: RenderConfig,
                 rows: int, shard_splats: bool = False, row_stride: int = 1,
                 band_budget_factor: float | None = 2.5,
                 gather_budget_factor: float | None = None,
                 exchange: bool = False, n_shards: int = 1,
                 exchange_budget_factor: float = 3.0,
                 precull_budget_factor: float | None = None,
                 idx: int | None = None, group=None,
                 return_aux: bool = False, use_kernel: bool = True):
    """One rank's program: render its tile rows, the contiguous band
    {idx * rows + s} (row_stride 1) or the interleaved rows {idx + s *
    n_shards} (row_stride n_shards).

    ``idx`` defaults to this process's rank in ``group``; a concrete
    ``idx`` runs that shard's exact program in one process (the replicated
    modes need no collective).  ``shard_splats`` and ``exchange`` take the
    collectives of the JAX body over ``group``.  ``use_kernel`` picks the
    blend's executor: the kernels, or the tile executor.

    Returns the band's image rows (rows * tile_size, tiles_x * tile_size,
    3) in local order, background composited; with ``return_aux`` also
    {"kept": splats the band's compaction kept, "dropped": splats past a
    budget, "num_duplicates", "truncated", "overflow"}, each a () tensor.
    A surfel (2DGS) scene is refused: the band programs carry 3DGS rows.
    """
    if scene.surfel:
        raise NotImplementedError(
            "the sharded render takes 3DGS scenes only; render a surfel "
            "(2DGS) scene with ops.render.render")
    if idx is None:
        idx = dist.get_rank(group)
    idx = int(idx)
    row0 = idx * (rows if row_stride == 1 else 1)
    ty_hi = _band_top(rows, row0, row_stride)
    dev = scene.xyz.device
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    kept_n = None

    if (precull_budget_factor is not None and rows < cfg.tiles_y
            and not shard_splats):
        # the conservative pre-cull before projection: projection then runs
        # on this band's candidates only; band compaction is subsumed
        mask = band_precull_mask(scene, view, proj, cfg, row0, ty_hi,
                                 row_stride)
        n_all = mask.shape[0]
        frac = min(1.0, rows / cfg.tiles_y * precull_budget_factor)
        budget = _round_budget(int(n_all * frac), n_all)
        # ONE row gather of the flat (N, 11 + sh) scene
        (wide_c,), kept, drop = compact_by_mask((scene.flat(),), mask,
                                                budget)
        scene = GaussianData.from_flat(wide_c, scene.sh_dim)
        # tail rows past the kept count are masked through their opacity
        # (projection treats opacity 0 as padding)
        scene = dataclasses.replace(scene, opacity=torch.where(
            kept[:, None], scene.opacity, torch.zeros_like(scene.opacity)))
        dropped, kept_n = dropped + drop, kept.sum()
        band_budget_factor = None

    splats = project(scene, view, proj, cam_pos, cfg)
    if shard_splats and exchange:
        rows12, valid12, drop = _exchange_parts(
            splats, cfg, rows, n_shards, exchange_budget_factor, row_stride)
        dropped = dropped + drop
        splats = _splats_from_received(
            _AllToAll.apply(rows12, group).reshape(-1, _WIRE_COLS),
            _all_to_all_mask(valid12, group).reshape(-1))
    elif shard_splats:
        if gather_budget_factor is not None:
            # compact the frustum survivors before the gather: the
            # collective moves ~survivor rows instead of N / world
            n_loc = splats.valid.shape[0]
            budget = _round_budget(int(n_loc * gather_budget_factor), n_loc)
            splats, kept, drop = compact_splats(splats, splats.valid, budget)
            splats = dataclasses.replace(splats, valid=splats.valid & kept)
            dropped = dropped + drop
        packed, valid = pack_splats(splats)
        splats = _splats_from_received(
            _AllGather.apply(packed[:, :_WIRE_COLS], group),
            _all_gather_mask(valid, group))
    if band_budget_factor is not None and rows < cfg.tiles_y \
            and not exchange:
        # band compaction: only splats whose footprint meets this band's
        # rows are binned, so binning scales with the band's share
        n_all = splats.valid.shape[0]
        cnt = binning.tile_bbox(splats, cfg, ty_lo=row0, ty_hi=ty_hi,
                                row_stride=row_stride)[4]
        frac = min(1.0, rows / cfg.tiles_y * band_budget_factor)
        budget = _round_budget(int(n_all * frac), n_all)
        splats, kept, drop = compact_splats(splats, cnt > 0, budget)
        splats = dataclasses.replace(splats, valid=splats.valid & kept)
        dropped, kept_n = dropped + drop, kept.sum()

    binned = binning.bin_splats(splats, cfg, row_offset=row0,
                                local_rows=rows, row_stride=row_stride)
    img = band_image(*blend_tiles(
        cfg, rows, row_stride, binned.table, binned.tile_starts,
        binned.tile_counts, row0, use_kernel), cfg, rows)
    if not return_aux:
        return img
    if kept_n is None:
        kept_n = splats.valid.sum()
    return img, {"kept": kept_n, "dropped": dropped,
                 "num_duplicates": binned.num_duplicates,
                 "truncated": binned.truncated, "overflow": binned.overflow}


def band_image(rgb_tiles, trans_tiles, cfg: RenderConfig, rows: int):
    """A band's blended tiles (rows * tiles_x, P, 3) and (rows * tiles_x,
    P) as its image rows (rows * tile_size, tiles_x * tile_size, 3) in
    local order, background composited."""
    ts, tx_n = cfg.tile_size, cfg.tiles_x
    img = rgb_tiles.reshape(rows, tx_n, ts, ts, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(rows * ts, tx_n * ts, 3)
    trans = trans_tiles.reshape(rows, tx_n, ts, ts)
    trans = trans.permute(0, 2, 1, 3).reshape(rows * ts, tx_n * ts)
    return img + cfg.background * trans[..., None]


def band_pixel_rows(cfg: RenderConfig, n_shards: int, idx: int,
                    interleaved: bool = False) -> torch.Tensor:
    """The global image row of each of shard ``idx``'s band rows
    (rows * tile_size,) int64; rows at or past the image height are
    padding."""
    rows = _rows_per_shard(cfg, n_shards)
    stride = n_shards if interleaved else 1
    row0 = idx * (rows if stride == 1 else 1)
    ts = cfg.tile_size
    tiles = row0 + torch.arange(rows) * stride
    return (tiles[:, None] * ts + torch.arange(ts)[None, :]).reshape(-1)


# ---- the entry points

def make_sharded_render_fn(mesh: Mesh, cfg: RenderConfig,
                           shard_splats: bool = False,
                           interleaved: bool = False,
                           band_budget_factor: float | None = 2.5,
                           gather_budget_factor: float | None = None,
                           exchange: bool = False,
                           exchange_budget_factor: float = 3.0,
                           precull_budget_factor: float | None = None,
                           use_kernel: bool = True):
    """A sharded render: (scene, view, proj, cam_pos) -> the cropped (H, W,
    3) image on every rank.

    Each rank renders its tile rows (contiguous bands, or round-robin rows
    with ``interleaved``, which balances scenes whose density varies by
    row) and one all-gather assembles the image.  The scene lies on
    ``mesh.device``: replicated by default, or this rank's splat shard
    (``shard_scene_splats``) with ``shard_splats``, where projection is
    split over the ranks and the projected splats are all-gathered, or
    with ``exchange`` as well sent by all-to-all to the ranks whose rows
    they touch.  ``use_kernel=False`` blends each band on the tile
    executor instead of the kernels.

    Differentiable: every rank computes the same loss of the image, and a
    replicated scene's gradient on each rank is then its band's share,
    which ``all_reduce_grads`` sums; a splat shard's gradient comes back
    whole through the reduce-scatter (or the reverse all-to-all)."""
    if exchange and not shard_splats:
        raise ValueError("exchange=True requires shard_splats=True")
    n_shards = mesh.world_size
    rows = _rows_per_shard(cfg, n_shards)
    stride = n_shards if interleaved else 1
    ts = cfg.tile_size

    def render_fn(scene, view, proj, cam_pos):
        band = _render_band(
            scene, view, proj, cam_pos, cfg, rows, shard_splats, stride,
            band_budget_factor, gather_budget_factor, exchange, n_shards,
            exchange_budget_factor, precull_budget_factor, group=mesh.group,
            use_kernel=use_kernel)
        img = _GatherImage.apply(band, mesh.group)  # (n, rows * ts, W, 3)
        w = img.shape[2]
        if interleaved:
            # global tile row of (rank d, local row s) is d + s * n_shards
            img = img.reshape(n_shards, rows, ts, w, 3).permute(
                1, 0, 2, 3, 4)
        return img.reshape(n_shards * rows * ts, w, 3)[: cfg.height,
                                                       : cfg.width]

    return render_fn


def render_sharded(scene: GaussianData, view, proj, cam_pos,
                   cfg: RenderConfig, mesh: Mesh, use_kernel: bool = True):
    """One sharded render with the default modes."""
    return make_sharded_render_fn(mesh, cfg, use_kernel=use_kernel)(
        scene, view, proj, cam_pos)


def shard_scene_splats(scene: GaussianData, mesh: Mesh) -> GaussianData:
    """This rank's contiguous share of the scene's splats on
    ``mesh.device``, after padding to a multiple of the world size with
    inert splats (every rank passes the same scene)."""
    n_dev = mesh.world_size
    n = len(scene)
    if n % n_dev:
        scene = scene.pad_to(-(-n // n_dev) * n_dev)
    per = len(scene) // n_dev
    lo = mesh.rank * per
    return GaussianData(*(
        getattr(scene, f)[lo: lo + per].detach().to(mesh.device).clone()
        for f in _FIELDS))


def all_reduce_grads(params, mesh: Mesh):
    """Sum the parameters' gradients over the ranks: one all-reduce of
    every gradient flattened into one buffer in the order given (a missing
    gradient counts as zero), the sums written back to ``.grad``."""
    params = list(params)
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in params:
        p.grad = flat[off: off + p.numel()].view_as(p).clone()
        off += p.numel()


def make_sharded_train_step(mesh: Mesh, cfg: RenderConfig, optimizer=None,
                            shard_splats: bool = False,
                            interleaved: bool = False,
                            band_budget_factor: float | None = 2.5,
                            gather_budget_factor: float | None = None,
                            exchange: bool = False,
                            exchange_budget_factor: float = 3.0,
                            precull_budget_factor: float | None = None,
                            use_kernel: bool = True):
    """A multi-rank training step: L2 loss against a target image, the
    gradient summed over the ranks, an optimizer update.

    ``optimizer`` makes the optimizer from the parameter list (default
    ``torch.optim.Adam(params, lr=1e-3)``, the trainer's).  Returns
    step(scene, opt_state, view, proj, cam_pos, target) -> (scene,
    opt_state, loss), where ``scene`` holds leaf tensors that require grad
    (this rank's shard with ``shard_splats``), ``opt_state`` is the
    optimizer (None on the first call makes it) and ``loss`` is
    mean((img - target)^2) over the whole (H, W, 3) image.

    Each rank computes its band's share of that mean and calls backward();
    a replicated scene's gradients are then summed by one all-reduce in a
    fixed order (``all_reduce_grads``); a splat shard's come back whole
    from the reduce-scatter (or the reverse all-to-all).  ``use_kernel``
    as in ``make_sharded_render_fn``."""
    if exchange and not shard_splats:
        raise ValueError("exchange=True requires shard_splats=True")
    if optimizer is None:
        def optimizer(params):
            return torch.optim.Adam(params, lr=1e-3)
    n_shards = mesh.world_size
    rows = _rows_per_shard(cfg, n_shards)
    stride = n_shards if interleaved else 1
    y = band_pixel_rows(cfg, n_shards, mesh.rank, interleaved).to(
        mesh.device)
    live = y < cfg.height
    denom = float(cfg.height * cfg.width * 3)

    def step(scene, opt_state, view, proj, cam_pos, target):
        params = [getattr(scene, f) for f in _FIELDS]
        if opt_state is None:
            opt_state = optimizer(params)
        opt_state.zero_grad(set_to_none=True)
        band = _render_band(
            scene, view, proj, cam_pos, cfg, rows, shard_splats, stride,
            band_budget_factor, gather_budget_factor, exchange, n_shards,
            exchange_budget_factor, precull_budget_factor, group=mesh.group,
            use_kernel=use_kernel)
        err = band[live, : cfg.width] - target[y[live]]
        loss = (err * err).sum() / denom
        loss.backward()
        if not shard_splats:
            all_reduce_grads(params, mesh)
        opt_state.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.group)
        return scene, opt_state, loss

    return step
