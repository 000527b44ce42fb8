"""Differentiable tile blend: the per-tile front-to-back compositing behind
``rasterize_tiles``, the counterpart of the JAX package's ``blend_tiles``
custom_vjp, with its two executors behind ``use_kernel`` (JAX's
``use_pallas``).

``use_kernel=True``, the kernels.  Forward: under autograd with a table
that requires grad, kernel B2 (the train forward, which also keeps the
backward's residuals); otherwise kernel B1, so serving and eval renders
under ``no_grad`` never pay for the residuals.  Backward: kernel B3, a
back-to-front re-traversal from B2's checkpoints.  The kernels live in
ops/kernels/; CPU tensors run their plain PyTorch versions in both
directions.  They follow JAX's Pallas executor: 256-row windows, the early
stop tested once per window.

``use_kernel=False``, the tile executor: JAX's XLA executor
(``ops/blend.py:45-262`` there) in plain PyTorch, on any device.  Each
tile streams its rows in ``CHUNK``-row chunks from its own start and tests
its early stop before every chunk, as JAX's vmapped ``while_loop`` does;
all tiles of the row set run batched, and a tile leaves the batch when it
stops.  Within a chunk the transmittance is the chunk's exclusive product
times the tile's entering value, JAX's factorization.  The backward
re-traverses front to back with JAX's streaming VJP (the carried prefix
``a_dot``, ``max(1 - a, 1 - alpha_clamp)``, the ``unclamped`` gate, the
mode branches) and writes each chunk's rows into the table gradient:
tiles own disjoint rows, so the writes never collide (JAX's ``lax.scan``
over tiles without its serial order).  Its contractions are f32
elementwise products and sums (JAX: ``Precision.HIGHEST``), never a matmul
that TF32 could round, and its fragments are the kernels' (``fragments``:
the same expression order, CPU ``exp`` in f64).

The JAX module's ``_tile_pixel_grid`` lives beside the kernels as
``tile_pixel_grid``: the kernels and their plain versions must agree on it.
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_bwd import (
    tile_raster_bwd,
)
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    PLAIN_ELEMS,
    fragments,
    tile_pixel_grid,
    tile_raster_fwd,
    tile_raster_fwd_train,
)
from gaussiansplattingviewer_tpu_torch.utils import profiling

CHUNK = 16  # the tile executor's chunk (JAX ops/blend.py:45)
_RGB = (binning.COL_R, binning.COL_G, binning.COL_BCH)


class _BlendTiles(torch.autograd.Function):
    """(table, starts, counts) -> (rgb, trans) on the kernels; gradient
    w.r.t. the table only (starts and counts are integers)."""

    @staticmethod
    def forward(ctx, table, starts, counts, cfg, local_rows, row_stride,
                row_offset):
        rgb, trans, ckpt, nproc = tile_raster_fwd_train(
            table, starts, counts, row_offset, cfg, local_rows, row_stride)
        ctx.save_for_backward(table, starts, counts, trans, ckpt, nproc)
        ctx.args = (cfg, local_rows, row_stride, row_offset)
        ctx.request = profiling.request()
        return rgb, trans

    @staticmethod
    def backward(ctx, g_rgb, g_trans):
        table, starts, counts, trans, ckpt, nproc = ctx.saved_tensors
        cfg, local_rows, row_stride, row_offset = ctx.args
        with profiling.span("blend_bwd", table.device, request=ctx.request):
            g_rgb, g_trans = _cotangents(g_rgb, g_trans, trans)
            g_table = tile_raster_bwd(
                table, starts, counts, nproc, ckpt, row_offset, g_rgb,
                g_trans, trans, cfg, local_rows, row_stride)
        return g_table, None, None, None, None, None, None


def _cotangents(g_rgb, g_trans, trans):
    """The image cotangents, zeros where autograd passes None."""
    g_rgb = (torch.zeros((*trans.shape, 3), dtype=trans.dtype,
                         device=trans.device)
             if g_rgb is None else g_rgb.contiguous())
    g_trans = (torch.zeros_like(trans) if g_trans is None
               else g_trans.contiguous())
    return g_rgb, g_trans


# ---- the tile executor


def _excl_prefix_prod(one_m):
    """The exclusive product of (A, S, P) along its rows (dim 1)."""
    shifted = torch.cat([torch.ones_like(one_m[:, :1]), one_m[:, :-1]], dim=1)
    return torch.cumprod(shifted, dim=1)


def _chunk_steps(table, starts, counts, px, py, trans, cfg: RenderConfig,
                 surfel: bool = False):
    """The tile executor's traversal: yields each chunk step of the tiles
    still running as (act, idx, live, rows, frags).

    act (A,) the tiles' indices, idx (A, CHUNK) their chunk's table
    columns, live (A, CHUNK) which of them lie before the tile's end, rows
    (11, A, CHUNK) the attributes cx .. ry (``surfel``: (15, A, CHUNK),
    cx .. Tw2 of a surfel table) (columns past the table's end
    read its last column, dead either way), frags the kernels'
    ``fragments`` of those rows against the tiles' pixels.  A tile runs a
    step while its chunk starts before its end and the largest of its
    transmittances ``trans`` (K, P) exceeds early_stop_transmittance, the
    condition of JAX's ``_blend_tile_fwd`` loop: the caller writes each
    step's exit transmittance into ``trans[act]`` before asking for the
    next.  Tiles run in groups that bound the fragment tensors'
    size."""
    dev = table.device
    n_tiles, pixels = px.shape
    start = starts[:-1].to(torch.int64)
    end = start + counts.to(torch.int64)
    attrs = table[: binning.SURFEL_ATTRS if surfel else binning.BLEND_ATTRS]
    last = table.shape[1] - 1
    lanes = torch.arange(CHUNK, device=dev)
    group = max(1, PLAIN_ELEMS.get(dev.type, 1 << 22) // (CHUNK * pixels))
    for g0 in range(0, n_tiles, group):
        act = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        step = 0
        while act.numel():
            off = start[act] + step * CHUNK
            go = (off < end[act]) & (
                trans[act].amax(dim=1) > cfg.early_stop_transmittance)
            act, off = act[go], off[go]
            if not act.numel():
                break
            idx = off[:, None] + lanes
            live = idx < end[act][:, None]
            rows = attrs[:, idx.clamp(max=last)]
            yield act, idx, live, rows, fragments(rows, live, px[act],
                                                  py[act], cfg)
            step += 1


def _tile_fwd(table, starts, counts, px, py, cfg: RenderConfig,
              surfel: bool = False):
    """JAX's ``_blend_tile_fwd`` over every tile: rgb (K, P, 3) and the
    final transmittance (K, P); ``surfel``: of a surfel table."""
    n_tiles, pixels = px.shape
    rgb = torch.zeros((n_tiles, pixels, 3), dtype=torch.float32,
                      device=table.device)
    trans = torch.ones((n_tiles, pixels), dtype=torch.float32,
                       device=table.device)
    for act, _, _, rows, (_, _, gauss, alpha, _) in _chunk_steps(
            table, starts, counts, px, py, trans, cfg, surfel):
        one_m = 1.0 - alpha
        prefix = _excl_prefix_prod(one_m)
        t = trans[act]
        w = alpha * prefix * t[:, None, :]
        if cfg.mode == RenderMode.GAUSSIAN_BALL:
            w = w * gauss
        rgb[act] = rgb[act] + torch.stack(
            [(w * rows[c][:, :, None]).sum(dim=1) for c in _RGB], dim=-1)
        trans[act] = t * prefix[:, -1] * one_m[:, -1]
    return rgb, trans


def _tile_bwd(table, starts, counts, px, py, g_rgb, g_trans, out_rgb,
              out_trans, cfg: RenderConfig):
    """JAX's ``_blend_tile_bwd`` over every tile: the table gradient
    (16, Dpad), columns cx .. opacity of every row the forward reached
    (rgb only in billboard and ball modes, whose alpha is piecewise
    constant), zero elsewhere."""
    b = binning
    n_tiles, pixels = px.shape
    g_table = torch.zeros_like(table)
    trans = torch.ones((n_tiles, pixels), dtype=torch.float32,
                       device=table.device)
    a_dot = torch.zeros_like(trans)
    # g . out, and g_T T_fin, per pixel
    gdot_out = (g_rgb[..., 0] * out_rgb[..., 0]
                + g_rgb[..., 1] * out_rgb[..., 1]
                + g_rgb[..., 2] * out_rgb[..., 2])
    gt_out = g_trans * out_trans
    smooth = cfg.mode not in (RenderMode.BILLBOARD, RenderMode.FLAT_BALL,
                              RenderMode.GAUSSIAN_BALL)
    for act, idx, live, rows, (dx, dy, gauss, alpha, unclamped) in \
            _chunk_steps(table, starts, counts, px, py, trans, cfg):
        col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, S, 1)
        g = g_rgb[act][:, None]  # (A, 1, P, 3)
        one_m = 1.0 - alpha
        prefix = _excl_prefix_prod(one_m)
        t = trans[act]
        t_i = prefix * t[:, None, :]  # transmittance before each row
        w = alpha * t_i
        seg = torch.zeros((*idx.shape, b.TABLE_WIDTH), dtype=torch.float32,
                          device=table.device)
        if smooth:
            g_dot_c = g[..., 0] * col(b.COL_R) + g[..., 1] * col(b.COL_G) \
                + g[..., 2] * col(b.COL_BCH)
            # inclusive prefix of w g.c; g.S_i = g.out - A_dot_i
            a_dot_inc = a_dot[act][:, None, :] + torch.cumsum(w * g_dot_c,
                                                              dim=1)
            one_m_safe = torch.clamp(one_m, min=1.0 - cfg.alpha_clamp)
            s_dot = gdot_out[act][:, None, :] - a_dot_inc
            dl_da = t_i * g_dot_c - s_dot / one_m_safe \
                - gt_out[act][:, None, :] / one_m_safe
            dl_da = torch.where(alpha > 0.0, dl_da, 0.0)
            d_power = torch.where(unclamped, dl_da * col(b.COL_OPACITY)
                                  * gauss, 0.0)
            seg[..., b.COL_OPACITY] = torch.where(
                unclamped, dl_da * gauss, 0.0).sum(dim=2)
            seg[..., b.COL_A] = (d_power * (-0.5 * dx * dx)).sum(dim=2)
            seg[..., b.COL_B] = (d_power * (-dx * dy)).sum(dim=2)
            seg[..., b.COL_C] = (d_power * (-0.5 * dy * dy)).sum(dim=2)
            seg[..., b.COL_CX] = (d_power * (
                col(b.COL_A) * dx + col(b.COL_B) * dy)).sum(dim=2)
            seg[..., b.COL_CY] = (d_power * (
                col(b.COL_C) * dy + col(b.COL_B) * dx)).sum(dim=2)
            a_dot[act] = a_dot_inc[:, -1]
        elif cfg.mode == RenderMode.GAUSSIAN_BALL:
            w = w * gauss
        for i, c in enumerate(_RGB):
            seg[..., c] = (w * g[..., i]).sum(dim=2)
        g_table[:, idx[live]] = seg[live].T
        trans[act] = t * prefix[:, -1] * one_m[:, -1]
    return g_table


class _TileBlend(torch.autograd.Function):
    """(table, starts, counts) -> (rgb, trans) on the tile executor;
    gradient w.r.t. the table only."""

    @staticmethod
    def forward(ctx, table, starts, counts, px, py, cfg):
        rgb, trans = _tile_fwd(table, starts, counts, px, py, cfg)
        ctx.save_for_backward(table, starts, counts, px, py, rgb, trans)
        ctx.cfg = cfg
        ctx.request = profiling.request()
        return rgb, trans

    @staticmethod
    def backward(ctx, g_rgb, g_trans):
        table, starts, counts, px, py, rgb, trans = ctx.saved_tensors
        with profiling.span("blend_bwd", table.device, request=ctx.request):
            g_rgb, g_trans = _cotangents(g_rgb, g_trans, trans)
            g_table = _tile_bwd(table, starts, counts, px, py, g_rgb,
                                g_trans, rgb, trans, ctx.cfg)
        return g_table, None, None, None, None, None


def blend_tiles(cfg: RenderConfig, local_rows: int, row_stride: int,
                table: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, row_offset: int = 0,
                use_kernel: bool = True, surfel: bool = False):
    """Blend all tiles of the row set {row_offset + s * row_stride}:
    attribute-major (16, Dpad) table -> rgb (T, P, 3), trans (T, P),
    differentiable w.r.t. the table.  ``use_kernel`` picks the kernels
    (their plain versions for CPU tensors), else the tile executor.
    ``surfel``: a surfel table, which no executor has a backward for:
    autograd differentiates the forwards on the CPU, the card refuses."""
    grad = torch.is_grad_enabled() and table.requires_grad
    if surfel and grad and table.device.type != "cpu":
        raise NotImplementedError("the blend of surfels has no backward "
                                  "kernel")
    grad = grad and not surfel
    if not use_kernel:
        px, py = tile_pixel_grid(cfg, local_rows, int(row_offset),
                                 row_stride, device=table.device)
        n_tiles = px.shape[0]
        if tuple(starts.shape) != (n_tiles + 1,) \
                or tuple(counts.shape) != (n_tiles,):
            raise ValueError(
                f"starts {tuple(starts.shape)} / counts "
                f"{tuple(counts.shape)} do not match {n_tiles} tiles")
        if grad:
            return _TileBlend.apply(table, starts, counts, px, py, cfg)
        return _tile_fwd(table, starts, counts, px, py, cfg, surfel)
    # grad mode is off inside Function.forward, so the choice of forward
    # kernel is made here
    if grad:
        return _BlendTiles.apply(table, starts, counts, cfg, local_rows,
                                 row_stride, row_offset)
    return tile_raster_fwd(table, starts, counts, row_offset, cfg,
                           local_rows, row_stride, surfel)
