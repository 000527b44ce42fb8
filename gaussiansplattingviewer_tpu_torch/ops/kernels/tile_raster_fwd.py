"""Kernel B1: the inference tile blend, hand-written in CUDA for Hopper.

Replaces ``gaussiansplattingviewer_tpu/ops/pallas/tile_raster_fwd.py``
``_fwd_kernel`` as launched by ``rasterize_binned_pallas_soa``.  The CUDA
source (``csrc/tile_raster_fwd.cu``) says what bounds it on an H100 (FP32
throughput: ~175 operations per table byte) and what its design does
about that (one CTA per tile, one thread per pixel, rows broadcast from
shared memory).

``tile_raster_fwd`` launches the kernel for CUDA tensors and runs
``tile_raster_fwd_plain``, its plain PyTorch version with the same
signature and semantics, for CPU tensors.  The plain version is the CPU
executor and the reference the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
from gaussiansplattingviewer_tpu_torch.ops.raster_oracle import fragment_exp

_MODE_CODE = {
    RenderMode.BILLBOARD: 1,
    RenderMode.FLAT_BALL: 2,
    RenderMode.GAUSSIAN_BALL: 3,
}
# fragment tensors the plain version holds at once, per (tile, row, pixel)
_PLAIN_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def tile_pixel_grid(cfg: RenderConfig, local_rows: int, row_offset: int = 0,
                    row_stride: int = 1, device="cpu"):
    """(T_local, P) pixel-centre coordinates of each tile of the row set
    {row_offset + s * row_stride : s < local_rows} (the port of
    ``ops/blend.py`` ``_tile_pixel_grid``; the kernel computes the same
    centres from its block index)."""
    ts = cfg.tile_size
    num_tiles = local_rows * cfg.tiles_x
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=device)
    tile_x = (tile_ids % cfg.tiles_x).to(torch.float32)
    tile_y = (tile_ids // cfg.tiles_x).to(torch.float32) * float(
        row_stride) + float(row_offset)
    local = torch.arange(ts * ts, dtype=torch.float32, device=device)
    lx = local % ts + 0.5
    ly = torch.div(local, ts, rounding_mode="floor") + 0.5
    px = tile_x[:, None] * ts + lx[None, :]
    py = tile_y[:, None] * ts + ly[None, :]
    return px, py


def _check_inputs(table, starts, counts, cfg, num_tiles):
    if cfg.tile_size != 16:
        raise ValueError(
            f"the blend kernel takes tile_size 16, got {cfg.tile_size}")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[0] != binning.TABLE_WIDTH:
        raise ValueError(
            f"table must be f32 ({binning.TABLE_WIDTH}, D), got "
            f"{table.dtype} {tuple(table.shape)}")
    if starts.dtype != torch.int32 or counts.dtype != torch.int32:
        raise ValueError("starts and counts must be int32")
    if tuple(starts.shape) != (num_tiles + 1,) \
            or tuple(counts.shape) != (num_tiles,):
        raise ValueError(
            f"starts {tuple(starts.shape)} / counts {tuple(counts.shape)} do "
            f"not match {num_tiles} tiles")
    if not (table.device == starts.device == counts.device):
        raise ValueError("table, starts and counts must share a device")


def tile_raster_fwd(table, starts, counts, row_offset, cfg: RenderConfig,
                    local_rows: int | None = None, row_stride: int = 1):
    """Blend every tile of the row set: attribute-major (16, Dpad) f32
    table, starts (T+1,) and counts (T,) int32 -> rgb (T, 256, 3) and final
    transmittance (T, 256), both f32.

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_fwd.launches``); CPU tensors run the plain version.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    _check_inputs(table, starts, counts, cfg, num_tiles)
    if table.device.type == "cpu":
        return tile_raster_fwd_plain(table, starts, counts, row_offset, cfg,
                                     local_rows, row_stride)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and starts.is_contiguous()
            and counts.is_contiguous()):
        raise ValueError("table, starts and counts must be contiguous")
    dev = table.device
    rgb = torch.empty((num_tiles, 256, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, 256), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return rgb, trans
    lib = build.load("tile_raster_fwd")
    fn = lib.gsv_tile_raster_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            table.data_ptr(), table.shape[1], starts.data_ptr(),
            counts.data_ptr(), num_tiles, int(row_offset), cfg.tiles_x,
            row_stride, _MODE_CODE.get(cfg.mode, 0), cfg.alpha_clamp,
            cfg.alpha_min, cfg.ball_threshold, cfg.early_stop_transmittance,
            rgb.data_ptr(), trans.data_ptr(), stream,
        )
    build.check(lib, rc, "tile_raster_fwd launch")
    tile_raster_fwd.launches += 1
    return rgb, trans


tile_raster_fwd.launches = 0


def tile_raster_fwd_plain(table, starts, counts, row_offset,
                          cfg: RenderConfig, local_rows: int | None = None,
                          row_stride: int = 1):
    """The plain PyTorch version of ``tile_raster_fwd`` (same signature,
    same results up to summation order)."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, int(row_offset), row_stride,
                             device=table.device)
    rgb, trans, _ = blend_tiles_plain(table, starts[:-1], counts, px, py, cfg)
    return rgb, trans


def _blend_window(rows, live, px, py, rgb, trans, cfg: RenderConfig):
    """Composite one window of rows into A tiles' accumulators.

    rows: (11, A, R) attributes, live: (A, R), px/py: (A, P),
    rgb: (A, P, 3), trans: (A, P).  Transmittance is the sequential product
    T, T(1-a_0), T(1-a_0)(1-a_1), ... (cumprod along a non-innermost dim is
    a sequential loop on both CPU and CUDA), so T matches the kernel's
    per-thread loop bit for bit; only the rgb sums are taken in another
    order."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    dx = px[:, None, :] - col(b.COL_CX)
    dy = py[:, None, :] - col(b.COL_CY)
    power = -0.5 * (col(b.COL_A) * dx * dx + col(b.COL_C) * dy * dy) \
        - col(b.COL_B) * dx * dy
    in_rect = (torch.abs(dx) <= col(b.COL_RX)) \
        & (torch.abs(dy) <= col(b.COL_RY)) & live[:, :, None]
    mode = cfg.mode
    gauss = None
    if mode == RenderMode.BILLBOARD:
        alpha = in_rect.to(torch.float32)
    else:
        gauss = fragment_exp(power)
        alpha = torch.clamp(col(b.COL_OPACITY) * gauss, max=cfg.alpha_clamp)
        keep = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        if mode in (RenderMode.FLAT_BALL, RenderMode.GAUSSIAN_BALL):
            alpha = (keep & (alpha > cfg.ball_threshold)).to(torch.float32)
    seq = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha], dim=1),
                        dim=1)
    weight = alpha * seq[:, :-1]
    if mode == RenderMode.GAUSSIAN_BALL:
        weight = weight * gauss
    rgb = rgb + torch.stack(
        [(weight * col(c)).sum(dim=1) for c in (b.COL_R, b.COL_G, b.COL_BCH)],
        dim=-1,
    )
    return rgb, seq[:, -1]


def blend_tiles_plain(table, start, count, px, py, cfg: RenderConfig):
    """Blend any set of tiles: start/count (K,) their table segments,
    px/py (K, P) their pixel centres.  Returns rgb (K, P, 3), trans (K, P)
    and the windows each tile processed (K,) int64.

    Mirrors the kernel: 256-row windows aligned to 128 rows, the tile-wide
    stop after each window.  Tiles go in bounded groups so memory stays
    bounded; within a window only each tile's live rows are evaluated (dead
    rows have alpha 0, which leaves T and rgb exactly unchanged)."""
    dev = table.device
    K, P = px.shape
    start = start.to(torch.int64)
    end = start + count.to(torch.int64)
    base = torch.div(start, binning.SEGMENT_ALIGN, rounding_mode="floor") \
        * binning.SEGMENT_ALIGN
    chunk = binning.KERNEL_CHUNK
    nchunks = torch.where(
        end > start, torch.div(end - base + chunk - 1, chunk,
                               rounding_mode="floor"),
        torch.zeros_like(end))
    attrs = table[: binning.COL_RY + 1]
    rgb = torch.zeros((K, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((K, P), dtype=torch.float32, device=dev)
    nproc = torch.zeros((K,), dtype=torch.int64, device=dev)
    group = max(1, _PLAIN_ELEMS.get(dev.type, 1 << 22) // (chunk * P))
    for g0 in range(0, K, group):
        ids = torch.arange(g0, min(g0 + group, K), device=dev)
        act = ids[nchunks[ids] > 0]
        ci = 0
        while act.numel():
            w0 = base[act] + ci * chunk
            lo = torch.maximum(start[act], w0)
            nrow = torch.minimum(end[act], w0 + chunk) - lo
            r = torch.arange(int(nrow.max()), device=dev)
            live = r[None, :] < nrow[:, None]
            idx = torch.where(live, lo[:, None] + r[None, :], lo[:, None])
            rgb_a, trans_a = _blend_window(
                attrs[:, idx], live, px[act], py[act], rgb[act], trans[act],
                cfg)
            rgb[act] = rgb_a
            trans[act] = trans_a
            nproc[act] += 1
            ci += 1
            go_on = (ci < nchunks[act]) & (
                trans_a.amax(dim=1) > cfg.early_stop_transmittance)
            act = act[go_on]
    return rgb, trans, nproc
