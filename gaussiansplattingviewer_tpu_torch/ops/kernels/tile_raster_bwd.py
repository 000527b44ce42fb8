"""Kernels B3 and B5: the tile blend backward, hand-written in CUDA for
Hopper.

B3 (``tile_raster_bwd``) replaces ``gaussiansplattingviewer_tpu/ops/
pallas/tile_raster_bwd.py`` ``_bwd_kernel`` (fused=False) as launched by
``blend_bwd_pallas_soa``; B5 (``tile_raster_bwd_fused``) the same kernel
with fused=True as launched by ``blend_bwd_fused``, the fused path's
compact backward (seeded suffix and entering transmittance, gradients at
per-tile compact offsets with the splat id beside them).  The CUDA source
(``csrc/tile_raster_bwd.cu``) gives the gradient math, the traversal (back
to front from the forward's checkpoints), the fixed-order reduction, the
exact warp cull, what bounds it on an H100 (FP32 issue) and what its
design does about that.  ``warp_cull_plain`` (in ``tile_raster_fwd.py``,
whose kernels cull the same way) is the plain mirror of the cull,
``kernel_occupancy`` reports the kernels' resources as built.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``, same signature and semantics) for CPU
tensors.  The plain version is the CPU
executor and the reference the kernel is held against on the card: t_i and
alpha are the kernel's bit for bit, and the suffix S runs in the kernel's
order, so only the sums over a row's 256 pixels differ in order.
"""

from __future__ import annotations

import ctypes

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
# BANDS and warp_cull_plain are re-exported: the backward culls as the
# forward does
from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
    BANDS,
    MODE_CODE,
    PLAIN_ELEMS,
    SCAN_BLOCK,
    check_inputs,
    ckpt_rows,
    fragments,
    stream_of,
    tile_pixel_grid,
    warp_cull_pixels,
    warp_cull_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _check_residuals(table, nproc, ckpt, g_rgb, g_trans, out_trans,
                     num_tiles, p, **fused):
    shapes = [(nproc, (num_tiles,), torch.int32),
              (ckpt, (ckpt_rows(p), table.shape[1]), torch.float32),
              (g_rgb, (num_tiles, p, 3), torch.float32),
              (g_trans, (num_tiles, p), torch.float32),
              (out_trans, (num_tiles, p), torch.float32)]
    if fused:
        shapes += [(fused["goff"], (num_tiles,), torch.int32),
                   (fused["suffix_init"], (num_tiles, p), torch.float32),
                   (fused["t_entry"], (num_tiles, p), torch.float32)]
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != table.device:
            raise ValueError("all inputs must share the table's device")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def tile_raster_bwd(table, starts, counts, nproc, ckpt, row_offset, g_rgb,
                    g_trans, out_trans, cfg: RenderConfig,
                    local_rows: int | None = None, row_stride: int = 1):
    """Kernel B3.  Gradient of the blend w.r.t. the attribute-major table.

    table (16, Dpad) f32, starts (T+1,) / counts (T,) int32; nproc (T,)
    int32 and ckpt (2, Dpad) f32 are kernel B2's residuals; g_rgb
    (T, 256, 3) and g_trans (T, 256) the cotangents of B2's outputs, and
    out_trans (T, 256) its final transmittance.  Returns g_table (16, Dpad)
    f32: columns cx .. opacity (0-8) of every live row of the windows each
    tile processed (rgb 5-7 only in billboard and ball modes); zero
    elsewhere.

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_bwd.launches``); CPU tensors run the plain version.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles, train=True)
    _check_residuals(table, nproc, ckpt, g_rgb, g_trans, out_trans,
                     num_tiles, cfg.tile_size ** 2)
    if table.device.type == "cpu":
        return tile_raster_bwd_plain(table, starts, counts, nproc, ckpt,
                                     row_offset, g_rgb, g_trans, out_trans,
                                     cfg, local_rows, row_stride)
    g_table = torch.zeros_like(table)
    if num_tiles:
        _bwd_cuda(table, starts, counts, nproc, None, ckpt, row_offset,
                  g_rgb, g_trans, out_trans, None, None, g_table, cfg,
                  num_tiles, row_stride)
        tile_raster_bwd.launches += 1
    return g_table


tile_raster_bwd.launches = 0


def _bwd_cuda(table, starts, counts, nproc, goff, ckpt, row_offset, g_rgb,
              g_trans, out_trans, suffix_init, t_entry, g_out,
              cfg: RenderConfig, num_tiles, row_stride):
    """Launch ``csrc/tile_raster_bwd.cu``: B3 when ``goff`` is None, else
    B5 into the compact buffer ``g_out``."""
    if not cfg.alpha_clamp < 1.0:
        raise ValueError(
            f"the backward kernels take alpha_clamp < 1 (their divisor "
            f"max(1 - alpha, 1 - alpha_clamp) must be nonzero), got "
            f"{cfg.alpha_clamp}")
    dev = table.device
    lib = build.load("tile_raster_bwd")
    fused = goff is not None
    fn = lib.gsv_tile_raster_bwd_fused if fused else lib.gsv_tile_raster_bwd
    head = [table.data_ptr(), table.shape[1], starts.data_ptr(),
            counts.data_ptr(), nproc.data_ptr()] \
        + ([goff.data_ptr()] if fused else []) + [ckpt.data_ptr()]
    tail = [g_rgb.data_ptr(), g_trans.data_ptr(), out_trans.data_ptr()] \
        + ([suffix_init.data_ptr(), t_entry.data_ptr(), g_out.shape[1]]
           if fused else []) + [g_out.data_ptr(), stream_of(dev)]
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P] + [_P] * fused \
        + [_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P] \
        + [_P, _P, ctypes.c_longlong] * fused + [_P, _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        rc = fn(*head, num_tiles, int(row_offset), cfg.tiles_x, row_stride,
                MODE_CODE.get(cfg.mode, 0), cfg.alpha_clamp,
                1.0 - cfg.alpha_clamp, cfg.alpha_min, cfg.ball_threshold,
                *tail)
    build.check(lib, rc, f"{fn.__name__} launch")


def kernel_occupancy(mode: RenderMode, fused: bool) -> dict:
    """Resources of the B3 (``fused`` False) or B5 instantiation for
    ``mode`` as built: registers and spilled bytes per thread, shared
    memory per CTA, and CTAs one SM holds at once.  Needs the card."""
    lib = build.load("tile_raster_bwd")
    fn = lib.gsv_tile_raster_bwd_occupancy
    fn.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 4
    fn.restype = _I
    vals = [_I() for _ in range(4)]
    rc = fn(MODE_CODE.get(mode, 0), int(fused),
            *(ctypes.byref(v) for v in vals))
    build.check(lib, rc, "gsv_tile_raster_bwd_occupancy")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm"), (v.value for v in vals)))


def tile_raster_bwd_fused(table, starts, counts, nproc, goff, ckpt,
                          row_offset, g_rgb, g_trans, out_trans, suffix_init,
                          t_entry, grad_rows: int, cfg: RenderConfig,
                          local_rows: int | None = None,
                          row_stride: int = 1):
    """Kernel B5, the fused path's compact backward.

    As ``tile_raster_bwd``, except: the suffix carry starts from
    ``suffix_init`` (T, 256) and the tile's first block enters with
    ``t_entry`` (T, 256) instead of 1.0; the gradients of the row at table
    column w0 + j of window ci land at column ``goff[t]`` + ci * 256 + j of
    a (16, grad_rows) f32 buffer, whose row 15 receives the table's row 15
    (the splat id).  goff (T,) int32 are 256-multiples giving each tile a
    region of nproc * 256 columns; the caller sets nproc to 0 for tiles
    whose region does not fit.  Columns no live row lands on stay 0 (id 0,
    gradient 0).

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_bwd_fused.launches``); CPU tensors run the plain version.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles, train=True)
    _check_residuals(table, nproc, ckpt, g_rgb, g_trans, out_trans,
                     num_tiles, cfg.tile_size ** 2, goff=goff,
                     suffix_init=suffix_init, t_entry=t_entry)
    if table.device.type == "cpu":
        return tile_raster_bwd_fused_plain(
            table, starts, counts, nproc, goff, ckpt, row_offset, g_rgb,
            g_trans, out_trans, suffix_init, t_entry, grad_rows, cfg,
            local_rows, row_stride)
    g_out = torch.zeros((binning.TABLE_WIDTH, grad_rows),
                        dtype=torch.float32, device=table.device)
    if num_tiles:
        _bwd_cuda(table, starts, counts, nproc, goff, ckpt, row_offset,
                  g_rgb, g_trans, out_trans, suffix_init, t_entry, g_out,
                  cfg, num_tiles, row_stride)
        tile_raster_bwd_fused.launches += 1
    return g_out


tile_raster_bwd_fused.launches = 0


def tile_raster_bwd_plain(table, starts, counts, nproc, ckpt, row_offset,
                          g_rgb, g_trans, out_trans, cfg: RenderConfig,
                          local_rows: int | None = None,
                          row_stride: int = 1):
    """The plain PyTorch version of ``tile_raster_bwd`` (same signature,
    same results up to the order of the per-row pixel sums)."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, int(row_offset), row_stride,
                             device=table.device)
    return blend_tiles_bwd_plain(table, starts[:-1], counts, nproc, ckpt,
                                 px, py, g_rgb, g_trans, out_trans, cfg)


def tile_raster_bwd_fused_plain(table, starts, counts, nproc, goff, ckpt,
                                row_offset, g_rgb, g_trans, out_trans,
                                suffix_init, t_entry, grad_rows: int,
                                cfg: RenderConfig,
                                local_rows: int | None = None,
                                row_stride: int = 1):
    """The plain PyTorch version of ``tile_raster_bwd_fused`` (same
    signature, same results up to the order of the per-row pixel sums)."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, int(row_offset), row_stride,
                             device=table.device)
    return blend_tiles_bwd_plain(
        table, starts[:-1], counts, nproc, ckpt, px, py, g_rgb, g_trans,
        out_trans, cfg, suffix_init=suffix_init, t_entry=t_entry, goff=goff,
        grad_rows=grad_rows)


def _block_grads(rows, live, t0, suffix, px, py, g_rgb, gto,
                 cfg: RenderConfig, cull=False):
    """Gradients of one 128-row block of A tiles, back to front.

    rows (11, A, R), live (A, R), t0 / suffix / gto (A, P) the block's
    entering T, the suffix carry from later rows and g_T * T_fin; g_rgb
    (A, P, 3).  With ``cull`` every fragment outside the pairs
    ``warp_cull_plain`` keeps is zeroed (alpha 0, not unclamped), as the
    kernels skip them.  Returns ({table column: (A, R) per-row sum}, new
    carry)."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    dx, dy, gauss, alpha, unclamped = fragments(rows, live, px, py, cfg)
    if cull:
        kept = warp_cull_pixels(rows, live, px, py)
        alpha = torch.where(kept, alpha, zero)
        if unclamped is not None:
            unclamped = unclamped & kept
    # t_i: the kernel's sequential product from the block's checkpoint
    t_i = torch.cumprod(torch.cat([t0[:, None, :], 1.0 - alpha], dim=1),
                        dim=1)[:, :-1]
    w = alpha * t_i
    gdc = g_rgb[:, None, :, 0] * col(b.COL_R) \
        + g_rgb[:, None, :, 1] * col(b.COL_G) \
        + g_rgb[:, None, :, 2] * col(b.COL_BCH)
    u = w * gdc
    # strict suffix S_i = carry + u_{R-1} + ... + u_{i+1}, added in the
    # kernel's order (cumsum is sequential along a non-innermost dim)
    rev = torch.cumsum(torch.cat([suffix[:, None, :],
                                  torch.flip(u, dims=(1,))[:, :-1]], dim=1),
                       dim=1)
    s_i = torch.flip(rev, dims=(1,))
    carry = rev[:, -1] + u[:, 0]
    g = lambda v, c: (v * g_rgb[:, None, :, c]).sum(dim=2)  # noqa: E731
    if unclamped is None:
        w_c = w * gauss if cfg.mode == RenderMode.GAUSSIAN_BALL else w
        return {b.COL_R: g(w_c, 0), b.COL_G: g(w_c, 1),
                b.COL_BCH: g(w_c, 2)}, carry
    one_m_safe = torch.clamp(1.0 - alpha, min=1.0 - cfg.alpha_clamp)
    dl_da = t_i * gdc - (s_i + gto[:, None, :]) / one_m_safe
    dl_da = torch.where(alpha > 0.0, dl_da, zero)
    d_power = torch.where(unclamped, dl_da * col(b.COL_OPACITY) * gauss,
                          zero)
    ca, cb, cc = col(b.COL_A), col(b.COL_B), col(b.COL_C)
    s = lambda v: v.sum(dim=2)  # noqa: E731
    return {
        b.COL_CX: s(d_power * (ca * dx + cb * dy)),
        b.COL_CY: s(d_power * (cc * dy + cb * dx)),
        b.COL_A: s(d_power * (-0.5 * dx * dx)),
        b.COL_B: s(d_power * (-dx * dy)),
        b.COL_C: s(d_power * (-0.5 * dy * dy)),
        b.COL_R: g(w, 0), b.COL_G: g(w, 1), b.COL_BCH: g(w, 2),
        b.COL_OPACITY: s(torch.where(unclamped, dl_da * gauss, zero)),
    }, carry


def blend_tiles_bwd_plain(table, start, count, nproc, ckpt, px, py, g_rgb,
                          g_trans, out_trans, cfg: RenderConfig,
                          suffix_init=None, t_entry=None, goff=None,
                          grad_rows=None, cull=False):
    """Backward of ``blend_tiles_plain`` for any set of tiles: start/count
    (K,) their table segments, nproc (K,) the windows each processed, px/py
    (K, P) their pixel centres, g_rgb (K, P, 3), g_trans / out_trans
    (K, P).  Returns g_table shaped like ``table``; with ``goff`` (K,) the
    compact (16, grad_rows) buffer of kernel B5 instead (the row at column
    c of tile k at goff[k] + c - base[k], its id in row 15).

    Walks each tile's 128-row blocks back to front, the tiles in bounded
    groups; a block's rows start from its checkpoint (``t_entry``, default
    1.0, for the tile's first block), and the suffix carry (starting from
    ``suffix_init``, default 0) passes from block to block.  ``cull``
    zeroes the fragments the kernels' warp cull skips (``_block_grads``);
    the result is the same bits."""
    dev = table.device
    K, P = px.shape
    start = start.to(torch.int64)
    end = start + count.to(torch.int64)
    base = torch.div(start, SCAN_BLOCK, rounding_mode="floor") * SCAN_BLOCK
    chunk = binning.KERNEL_CHUNK
    nchunks = torch.where(
        end > start, torch.div(end - base + chunk - 1, chunk,
                               rounding_mode="floor"),
        torch.zeros_like(end))
    nblk = torch.minimum(nproc.to(torch.int64), nchunks) \
        * (chunk // SCAN_BLOCK)
    attrs = table[: binning.COL_RY + 1]
    gto = g_trans * out_trans
    if goff is None:
        g_table = torch.zeros_like(table)
        shift = torch.zeros_like(base)
    else:
        g_table = torch.zeros((binning.TABLE_WIDTH, grad_rows),
                              dtype=table.dtype, device=dev)
        shift = goff.to(torch.int64) - base
    suffix = torch.zeros((K, P), dtype=table.dtype, device=dev) \
        if suffix_init is None else suffix_init.clone()
    ck_cols = torch.arange(SCAN_BLOCK, device=dev)
    group = max(1, PLAIN_ELEMS.get(dev.type, 1 << 22) // (SCAN_BLOCK * P))
    for g0 in range(0, K, group):
        ids = torch.arange(g0, min(g0 + group, K), device=dev)
        act = ids[nblk[ids] > 0]
        k = 0
        while act.numel():
            blk = nblk[act] - 1 - k
            c0 = base[act] + blk * SCAN_BLOCK
            lo = torch.maximum(start[act], c0)
            nrow = (torch.minimum(end[act], c0 + SCAN_BLOCK) - lo).clamp(min=0)
            if int(nrow.max()) > 0:
                has = nrow > 0
                a_ids, c0, lo, nrow = act[has], c0[has], lo[has], nrow[has]
                r = torch.arange(int(nrow.max()), device=dev)
                live = r[None, :] < nrow[:, None]
                idx = torch.where(live, lo[:, None] + r[None, :], lo[:, None])
                ck = ckpt[:, c0[:, None] + ck_cols].permute(1, 0, 2)
                first = torch.ones((), device=dev) if t_entry is None \
                    else t_entry[a_ids]
                t0 = torch.where((c0 == base[a_ids])[:, None], first,
                                 ck.reshape(len(a_ids), -1)[:, :P])
                grads, carry = _block_grads(
                    attrs[:, idx], live, t0, suffix[a_ids], px[a_ids],
                    py[a_ids], g_rgb[a_ids], gto[a_ids], cfg, cull)
                suffix[a_ids] = carry
                dst = (idx + shift[a_ids][:, None])[live]
                keep = dst < g_table.shape[1]  # B5 drops writes past the end
                for c, v in grads.items():
                    g_table[c, dst[keep]] = v[live][keep]
                if goff is not None:
                    g_table[binning.COL_COUNT, dst[keep]] = \
                        table[binning.COL_COUNT, idx[live][keep]]
            k += 1
            act = act[k < nblk[act]]
    return g_table
