"""Kernels B1 and B2: the tile blend forward, hand-written in CUDA for
Hopper.

B1 (``tile_raster_fwd``) replaces ``gaussiansplattingviewer_tpu/ops/pallas/
tile_raster_fwd.py`` ``_fwd_kernel`` as launched by
``rasterize_binned_pallas_soa``; B2 (``tile_raster_fwd_train``) the same
kernel as launched by ``rasterize_binned_pallas_train``, which also emits
the backward's residuals (``nproc`` and the transmittance checkpoints
``ckpt``).  Both are one template in ``csrc/tile_raster_fwd.cu``, whose
header says what bounds them on an H100 (FP32 throughput: ~175 operations
per table byte), what the design does about that (one CTA per tile, one
thread per pixel, rows broadcast from shared memory) and why B2's
checkpoint writes cannot race.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``, same signature and semantics) for CPU
tensors.  The plain versions are the CPU executors and the references the
kernels are held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
from gaussiansplattingviewer_tpu_torch.ops.raster_oracle import fragment_exp

MODE_CODE = {
    RenderMode.BILLBOARD: 1,
    RenderMode.FLAT_BALL: 2,
    RenderMode.GAUSSIAN_BALL: 3,
}
# fragment tensors the plain versions hold at once, per (tile, row, pixel)
PLAIN_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}
# ckpt rows: pixel p's checkpoint lives in row p // SCAN_BLOCK
SCAN_BLOCK = binning.SEGMENT_ALIGN
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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


def check_inputs(table, starts, counts, cfg, num_tiles):
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
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type == "cuda" and not (
            table.is_contiguous() and starts.is_contiguous()
            and counts.is_contiguous()):
        raise ValueError("table, starts and counts must be contiguous")


def stream_of(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tile_raster_fwd(table, starts, counts, row_offset, cfg: RenderConfig,
                    local_rows: int | None = None, row_stride: int = 1):
    """Kernel B1.  Blend every tile of the row set: attribute-major
    (16, Dpad) f32 table, starts (T+1,) and counts (T,) int32 -> rgb
    (T, 256, 3) and final transmittance (T, 256), both f32.

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_fwd.launches``); CPU tensors run the plain version.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles)
    if table.device.type == "cpu":
        return tile_raster_fwd_plain(table, starts, counts, row_offset, cfg,
                                     local_rows, row_stride)
    dev = table.device
    rgb = torch.empty((num_tiles, 256, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, 256), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return rgb, trans
    lib = build.load("tile_raster_fwd")
    fn = lib.gsv_tile_raster_fwd
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I,
                   _F, _F, _F, _F, _P, _P, _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), table.shape[1], starts.data_ptr(),
            counts.data_ptr(), num_tiles, int(row_offset), cfg.tiles_x,
            row_stride, MODE_CODE.get(cfg.mode, 0), cfg.alpha_clamp,
            cfg.alpha_min, cfg.ball_threshold, cfg.early_stop_transmittance,
            rgb.data_ptr(), trans.data_ptr(), stream_of(dev),
        )
    build.check(lib, rc, "tile_raster_fwd launch")
    tile_raster_fwd.launches += 1
    return rgb, trans


tile_raster_fwd.launches = 0


def tile_raster_fwd_train(table, starts, counts, row_offset,
                          cfg: RenderConfig, local_rows: int | None = None,
                          row_stride: int = 1):
    """Kernel B2, the training forward: B1's (rgb, trans) plus the
    backward's residuals ckpt (2, Dpad) f32 and nproc (T,) int32.

    nproc[t] is the number of 256-row windows tile t processed before its
    early stop.  ckpt[p // 128, c + p % 128] is pixel p's transmittance
    entering the 128-row block that starts at table column c, for every
    block except a tile's first (entering value 1.0) that holds a live row
    of its tile; other columns stay 0.  CUDA tensors launch the kernel (one
    launch, counted in ``tile_raster_fwd_train.launches``); CPU tensors run
    the plain version, which writes the same columns with the same values.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles)
    if table.device.type == "cpu":
        return tile_raster_fwd_train_plain(table, starts, counts, row_offset,
                                           cfg, local_rows, row_stride)
    dev = table.device
    rgb = torch.empty((num_tiles, 256, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((num_tiles, 256), dtype=torch.float32, device=dev)
    nproc = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    ckpt = torch.zeros((256 // SCAN_BLOCK, table.shape[1]),
                       dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return rgb, trans, ckpt, nproc
    lib = build.load("tile_raster_fwd")
    fn = lib.gsv_tile_raster_fwd_train
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I,
                   _F, _F, _F, _F, _P, _P, _P, _P, _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), table.shape[1], starts.data_ptr(),
            counts.data_ptr(), num_tiles, int(row_offset), cfg.tiles_x,
            row_stride, MODE_CODE.get(cfg.mode, 0), cfg.alpha_clamp,
            cfg.alpha_min, cfg.ball_threshold, cfg.early_stop_transmittance,
            rgb.data_ptr(), trans.data_ptr(), nproc.data_ptr(),
            ckpt.data_ptr(), stream_of(dev),
        )
    build.check(lib, rc, "tile_raster_fwd_train launch")
    tile_raster_fwd_train.launches += 1
    return rgb, trans, ckpt, nproc


tile_raster_fwd_train.launches = 0


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


def tile_raster_fwd_train_plain(table, starts, counts, row_offset,
                                cfg: RenderConfig,
                                local_rows: int | None = None,
                                row_stride: int = 1):
    """The plain PyTorch version of ``tile_raster_fwd_train``: T, ckpt and
    nproc equal the kernel's bit for bit, rgb up to summation order."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, int(row_offset), row_stride,
                             device=table.device)
    ckpt = torch.zeros((256 // SCAN_BLOCK, table.shape[1]),
                       dtype=torch.float32, device=table.device)
    rgb, trans, nproc = blend_tiles_plain(table, starts[:-1], counts, px, py,
                                          cfg, ckpt=ckpt)
    return rgb, trans, ckpt, nproc.to(torch.int32)


def fragments(rows, live, px, py, cfg: RenderConfig):
    """The kernels' fragment math for A tiles' rows against their pixels,
    in the kernels' expression order (so alpha is theirs bit for bit).

    rows: (11, A, R) attributes, live: (A, R), px/py: (A, P).  Returns
    (dx, dy, gauss, alpha, unclamped), each (A, R, P): gauss is all ones
    in billboard mode; unclamped (kept and op * gauss < alpha_clamp, where
    d alpha / d raw is 1) is None in billboard and ball modes."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    dx = px[:, None, :] - col(b.COL_CX)
    dy = py[:, None, :] - col(b.COL_CY)
    power = -0.5 * (col(b.COL_A) * dx * dx + col(b.COL_C) * dy * dy) \
        - col(b.COL_B) * dx * dy
    in_rect = (torch.abs(dx) <= col(b.COL_RX)) \
        & (torch.abs(dy) <= col(b.COL_RY)) & live[:, :, None]
    if cfg.mode == RenderMode.BILLBOARD:
        return dx, dy, torch.ones_like(power), in_rect.to(torch.float32), \
            None
    gauss = fragment_exp(power)
    raw = col(b.COL_OPACITY) * gauss
    alpha = torch.clamp(raw, max=cfg.alpha_clamp)
    keep = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    if cfg.mode in (RenderMode.FLAT_BALL, RenderMode.GAUSSIAN_BALL):
        alpha = (keep & (alpha > cfg.ball_threshold)).to(torch.float32)
        return dx, dy, gauss, alpha, None
    return dx, dy, gauss, alpha, keep & (raw < cfg.alpha_clamp)


def _blend_window(rows, live, px, py, rgb, trans, cfg: RenderConfig,
                  n_first=None):
    """Composite one window of rows into A tiles' accumulators.

    rows: (11, A, R) attributes, live: (A, R), px/py: (A, P),
    rgb: (A, P, 3), trans: (A, P).  Transmittance is the sequential product
    T, T(1-a_0), T(1-a_0)(1-a_1), ... (cumprod along a non-innermost dim is
    a sequential loop on both CPU and CUDA), so T matches the kernel's
    per-thread loop bit for bit; only the rgb sums are taken in another
    order.  Returns (rgb, exit T, T after the first ``n_first`` (A,) rows
    or None)."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    _, _, gauss, alpha, _ = fragments(rows, live, px, py, cfg)
    seq = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha], dim=1),
                        dim=1)
    weight = alpha * seq[:, :-1]
    if cfg.mode == RenderMode.GAUSSIAN_BALL:
        weight = weight * gauss
    rgb = rgb + torch.stack(
        [(weight * col(c)).sum(dim=1) for c in (b.COL_R, b.COL_G, b.COL_BCH)],
        dim=-1,
    )
    t_first = None
    if n_first is not None:
        t_first = seq[torch.arange(seq.shape[0], device=seq.device), n_first]
    return rgb, seq[:, -1], t_first


def _put_ckpt(ckpt, cols, t_blk):
    """ckpt[p // 128, c + p % 128] = t_blk[:, p] for each column c."""
    a = cols.shape[0]
    if a == 0:
        return
    idx = cols[:, None] + torch.arange(SCAN_BLOCK, device=cols.device)
    ckpt[:, idx] = t_blk.reshape(a, -1, SCAN_BLOCK).permute(1, 0, 2)


def blend_tiles_plain(table, start, count, px, py, cfg: RenderConfig,
                      ckpt=None):
    """Blend any set of tiles: start/count (K,) their table segments,
    px/py (K, P) their pixel centres.  Returns rgb (K, P, 3), trans (K, P)
    and the windows each tile processed (K,) int64.

    Mirrors the kernel: 256-row windows aligned to 128 rows, the tile-wide
    stop after each window.  Tiles go in bounded groups so memory stays
    bounded; within a window only each tile's live rows are evaluated (dead
    rows have alpha 0, which leaves T and rgb exactly unchanged).  With
    ``ckpt`` given, each window also writes the checkpoints kernel B2
    writes: the T leaving each 128-row block at the next block's columns,
    where that block holds a live row of the tile."""
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
    group = max(1, PLAIN_ELEMS.get(dev.type, 1 << 22) // (chunk * P))
    for g0 in range(0, K, group):
        ids = torch.arange(g0, min(g0 + group, K), device=dev)
        act = ids[nchunks[ids] > 0]
        ci = 0
        while act.numel():
            w0 = base[act] + ci * chunk
            e = end[act]
            lo = torch.maximum(start[act], w0)
            nrow = torch.minimum(e, w0 + chunk) - lo
            r = torch.arange(int(nrow.max()), device=dev)
            live = r[None, :] < nrow[:, None]
            idx = torch.where(live, lo[:, None] + r[None, :], lo[:, None])
            # rows of the window's first 128-row block
            n_first = None if ckpt is None else \
                torch.minimum(e, w0 + SCAN_BLOCK) - lo
            rgb_a, trans_a, t_mid = _blend_window(
                attrs[:, idx], live, px[act], py[act], rgb[act], trans[act],
                cfg, n_first)
            if ckpt is not None:
                for c, t_blk in ((w0 + SCAN_BLOCK, t_mid),
                                 (w0 + chunk, trans_a)):
                    own = c < e
                    _put_ckpt(ckpt, c[own], t_blk[own])
            rgb[act] = rgb_a
            trans[act] = trans_a
            nproc[act] += 1
            ci += 1
            go_on = (ci < nchunks[act]) & (
                trans_a.amax(dim=1) > cfg.early_stop_transmittance)
            act = act[go_on]
    return rgb, trans, nproc
