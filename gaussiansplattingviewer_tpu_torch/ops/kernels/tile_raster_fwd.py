"""Kernels B1, B2 and B4: the tile blend forward, hand-written in CUDA for
Hopper.

B1 (``tile_raster_fwd``) replaces ``gaussiansplattingviewer_tpu/ops/pallas/
tile_raster_fwd.py`` ``_fwd_kernel`` as launched by
``rasterize_binned_pallas_soa``; B2 (``tile_raster_fwd_train``) the same
kernel as launched by ``rasterize_binned_pallas_train``, which also emits
the backward's residuals (``nproc`` and the transmittance checkpoints
``ckpt``); B4 (``tile_raster_fwd_seeded``) the kernel with ``seeded=True``
as launched by ``rasterize_binned_pallas_seeded``, the fused path's
residual pass, whose transmittance starts from pass 1's exit.  All are one
template in ``csrc/tile_raster_fwd.cu``, whose
header says what bounds them on an H100 (instruction issue: ~175 FP32
operations per table byte), what the design does about that (one CTA per
tile, two pixels of one column per thread, rows broadcast from shared
memory as 16-byte records, an exact per-warp cull; at 32x32 the bands are
8x8 squares, at 8x8 one 128-row block is staged at a time) and why B2's
checkpoint writes cannot race.  ``warp_cull_plain`` is the plain mirror of
the cull (``square_bands`` says where its bands are squares), which the
backward kernels (``tile_raster_bwd.py``) share; ``kernel_occupancy``
reports the kernels' resources as built.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``, same signature and semantics) for CPU
tensors.  The plain versions are the CPU executors and the references the
kernels are held against on the card.  Tiles hold P = tile_size ** 2
pixels.  On the card B1, B2, the inference B4 and the classic backward B3
take tile_size 8, 16 or 32 (``CUDA_TILES``), as the JAX package's XLA
executor trains at any size (``ops/blend.py``); the fused training kernels
(B4 with ``train``, B5) take 16 only (``FUSED_TRAIN_TILE``), which is the
JAX package's own limit: its fused path runs only through Pallas
(``ops/raster_tiles.py:68``), whose train kernel lays the transmittance
checkpoint out for 256 pixels (``ops/pallas/tile_raster_fwd.py:334``).
CUDA tensors at another size raise before any launch; the plain versions
take any.

Surfel tables (2D Gaussian splatting, ``surfel=True``: the rows
``binning.pack_table`` writes for a surfel scene) take the same template
with the ray-disk fragment (``surfel_fragments``) in place of the conic's,
built as its own library (``csrc/tile_raster_fwd_surfel.cu``), which a
3DGS render never builds or loads: B1s, B4s and, for the autotuner's
probe, B2s, at tiles 8, 16 and 32, in SH and DEPTH modes.  Their warp cull
is a surfel's own (the bounding rect of the pixels its alpha can reach,
widened for rounding) and exact, so the plain versions blend every surfel
row and give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
from gaussiansplattingviewer_tpu_torch.ops.raster_oracle import fragment_exp

# a surfel fragment whose ray meets the disk's plane nearer than this is
# skipped (the official 2DGS rasterizer's near_n)
SURFEL_NEAR = 0.2
MODE_CODE = {
    RenderMode.BILLBOARD: 1,
    RenderMode.FLAT_BALL: 2,
    RenderMode.GAUSSIAN_BALL: 3,
}
# fragment tensors the plain versions hold at once, per (tile, row, pixel)
PLAIN_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}
# ckpt rows: pixel p's checkpoint lives in row p // SCAN_BLOCK
SCAN_BLOCK = binning.SEGMENT_ALIGN
# tile sizes of the CUDA kernels: B1, B2, B3 and the inference B4 any of
# CUDA_TILES, the fused training kernels (B4 train, B5) FUSED_TRAIN_TILE;
# the plain versions take any tile_size
CUDA_TILES = (8, 16, 32)
FUSED_TRAIN_TILE = 16
# a warp's footprint: 32 lanes x 2 pixels; in a 16x16 tile, band w is tile
# rows 4w .. 4w+3, i.e. pixels 64w .. 64w+63 (band_rows gives other sizes,
# square_bands where they are squares)
BAND_PIXELS = 64
BANDS = 16 * 16 // BAND_PIXELS  # of a 16x16 tile
SQUARE = 8  # edge of a square band (the kernels' at 32x32)
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


def ckpt_rows(pixels: int) -> int:
    """Rows of the checkpoint buffer for tiles of ``pixels`` pixels."""
    return -(-pixels // SCAN_BLOCK)


def check_tile_size(cfg, fused_train: bool = False) -> None:
    """Raise unless the CUDA kernels take ``cfg.tile_size``: the fused
    training kernels (``fused_train``) 16, the others any of CUDA_TILES."""
    ts = cfg.tile_size
    if ts not in CUDA_TILES:
        raise ValueError(
            f"the CUDA blend kernels take tile_size {CUDA_TILES}, got {ts} "
            f"(the plain versions, for CPU tensors, take any tile size)")
    if fused_train and ts != FUSED_TRAIN_TILE:
        raise ValueError(
            f"the CUDA fused training kernels (B4 with train=True, B5) take "
            f"tile_size {FUSED_TRAIN_TILE}, got {ts}: the JAX fused path "
            f"runs only through Pallas (gaussiansplattingviewer_tpu/ops/"
            f"raster_tiles.py:68), whose train kernel lays its checkpoint "
            f"out for 256 pixels (gaussiansplattingviewer_tpu/ops/pallas/"
            f"tile_raster_fwd.py:334); the classic path trains at "
            f"{CUDA_TILES}, and the plain versions, for CPU tensors, take "
            f"any tile size")


def check_inputs(table, starts, counts, cfg, num_tiles, fused_train=False,
                 surfel=False):
    """Validate a kernel's table and segments; for CUDA tensors also the
    tile size (``fused_train``: the fused training kernels' 16); surfel
    tables blend in the SH and DEPTH modes only."""
    if table.device.type == "cuda":
        check_tile_size(cfg, fused_train)
    if surfel and cfg.mode in MODE_CODE:
        raise ValueError(f"surfel tables blend in the SH and DEPTH modes "
                         f"only, not {cfg.mode.name}")
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


def _check_t_init(t_init, table, num_tiles, pixels):
    if t_init.dtype != torch.float32 or tuple(t_init.shape) != (num_tiles,
                                                                 pixels):
        raise ValueError(f"t_init must be f32 ({num_tiles}, {pixels}), got "
                         f"{t_init.dtype} {tuple(t_init.shape)}")
    if t_init.device != table.device:
        raise ValueError("t_init must share the table's device")
    if t_init.device.type == "cuda" and not t_init.is_contiguous():
        raise ValueError("t_init must be contiguous")


def _fwd_cuda(symbol, table, starts, counts, row_offset, cfg: RenderConfig,
              num_tiles, row_stride, t_init=None, train=False, surfel=False):
    """Launch one entry point of ``csrc/tile_raster_fwd.cu`` (with
    ``surfel`` of ``csrc/tile_raster_fwd_surfel.cu``): rgb, trans and,
    with ``train``, ckpt and nproc."""
    dev = table.device
    pixels = cfg.tile_size ** 2
    rgb = torch.empty((num_tiles, pixels, 3), dtype=torch.float32,
                      device=dev)
    trans = torch.empty((num_tiles, pixels), dtype=torch.float32, device=dev)
    outs = [rgb, trans]
    if train:
        nproc = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
        ckpt = torch.zeros((ckpt_rows(pixels), table.shape[1]),
                           dtype=torch.float32, device=dev)
        outs += [ckpt, nproc]
    if num_tiles == 0:
        return tuple(outs)
    lib = build.load(_source(surfel))
    fn = getattr(lib, symbol)
    fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I,
                   _F, _F, _F, _F] + [_P] * (
                       2 + (t_init is not None) + 2 * train + 1)
    fn.restype = _I
    ptrs = ([] if t_init is None else [t_init.data_ptr()]) \
        + [rgb.data_ptr(), trans.data_ptr()] \
        + ([nproc.data_ptr(), ckpt.data_ptr()] if train else [])
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), table.shape[1], starts.data_ptr(),
            counts.data_ptr(), num_tiles, int(row_offset), cfg.tiles_x,
            row_stride, cfg.tile_size, MODE_CODE.get(cfg.mode, 0),
            cfg.alpha_clamp,
            cfg.alpha_min, cfg.ball_threshold, cfg.early_stop_transmittance,
            *ptrs, stream_of(dev),
        )
    build.check(lib, rc, f"{symbol} launch")
    return tuple(outs)


def _source(surfel: bool) -> str:
    return "tile_raster_fwd_surfel" if surfel else "tile_raster_fwd"


def kernel_occupancy(mode: RenderMode, train: bool = False,
                     seeded: bool = False, tile_size: int = 16,
                     surfel: bool = False) -> dict:
    """Resources of the B1 (``train`` False), B2 (``train``) or B4
    (``seeded``, either variant) instantiation for ``mode`` and
    ``tile_size`` as built (``surfel``: B1s, B2s, B4s): registers and
    spilled bytes per thread, shared memory per CTA, and CTAs one SM holds
    at once.  Needs the card."""
    lib = build.load(_source(surfel))
    fn = lib.gsv_tile_raster_fwd_occupancy
    fn.argtypes = [_I, _I, _I, _I] + [ctypes.POINTER(_I)] * 4
    fn.restype = _I
    vals = [_I() for _ in range(4)]
    rc = fn(tile_size, MODE_CODE.get(mode, 0), int(train), int(seeded),
            *(ctypes.byref(v) for v in vals))
    build.check(lib, rc, "gsv_tile_raster_fwd_occupancy")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm"), (v.value for v in vals)))


def tile_raster_fwd(table, starts, counts, row_offset, cfg: RenderConfig,
                    local_rows: int | None = None, row_stride: int = 1,
                    surfel: bool = False):
    """Kernel B1 (``surfel``: B1s, of a surfel table).  Blend every tile
    of the row set: attribute-major (16, Dpad) f32 table, starts (T+1,)
    and counts (T,) int32 -> rgb (T, P, 3) and final transmittance
    (T, P), both f32.

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_fwd.launches``); CPU tensors run the plain version.
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles, surfel=surfel)
    if table.device.type == "cpu":
        return tile_raster_fwd_plain(table, starts, counts, row_offset, cfg,
                                     local_rows, row_stride, surfel)
    out = _fwd_cuda("gsv_tile_raster_fwd", table, starts, counts, row_offset,
                    cfg, num_tiles, row_stride, surfel=surfel)
    if num_tiles:
        tile_raster_fwd.launches += 1
    return out


tile_raster_fwd.launches = 0


def tile_raster_fwd_train(table, starts, counts, row_offset,
                          cfg: RenderConfig, local_rows: int | None = None,
                          row_stride: int = 1, surfel: bool = False):
    """Kernel B2, the training forward: B1's (rgb, trans) plus the
    backward's residuals ckpt (ceil(P / 128), Dpad) f32 and nproc (T,)
    int32.

    nproc[t] is the number of 256-row windows tile t processed before its
    early stop.  ckpt[p // 128, c + p % 128] is pixel p's transmittance
    entering the 128-row block that starts at table column c, for every
    block except a tile's first (entering value 1.0) that holds a live row
    of its tile; other columns stay 0 (at tile 8 also c + 64 .. c + 127).  CUDA tensors launch the kernel (one
    launch, counted in ``tile_raster_fwd_train.launches``); CPU tensors run
    the plain version, which writes the same columns with the same values.
    ``surfel``: B2s, of a surfel table (the autotuner's probe; no kernel
    differentiates surfels yet).
    """
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles, surfel=surfel)
    if table.device.type == "cpu":
        return tile_raster_fwd_train_plain(table, starts, counts, row_offset,
                                           cfg, local_rows, row_stride,
                                           surfel)
    out = _fwd_cuda("gsv_tile_raster_fwd_train", table, starts, counts,
                    row_offset, cfg, num_tiles, row_stride, train=True,
                    surfel=surfel)
    if num_tiles:
        tile_raster_fwd_train.launches += 1
    return out


tile_raster_fwd_train.launches = 0


def tile_raster_fwd_seeded(table, starts, counts, t_init, row_offset,
                           cfg: RenderConfig, local_rows: int | None = None,
                           row_stride: int = 1, train: bool = False,
                           surfel: bool = False):
    """Kernel B4, the fused path's residual pass: B1 (``train=False``) or
    B2 (``train=True``, adding ckpt and nproc) with each pixel's
    transmittance starting from ``t_init`` (T, P) f32 instead of 1.0;
    rgb accumulates from zero.  The tile's first block keeps no
    checkpoint: its entering transmittance is ``t_init``.

    CUDA tensors launch the kernel (one launch, counted in
    ``tile_raster_fwd_seeded.launches`` for either variant); CPU tensors
    run the plain version.  ``surfel``: B4s, of a surfel table."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    num_tiles = local_rows * cfg.tiles_x
    check_inputs(table, starts, counts, cfg, num_tiles, fused_train=train,
                 surfel=surfel)
    _check_t_init(t_init, table, num_tiles, cfg.tile_size ** 2)
    if table.device.type == "cpu":
        return tile_raster_fwd_seeded_plain(table, starts, counts, t_init,
                                            row_offset, cfg, local_rows,
                                            row_stride, train, surfel)
    symbol = "gsv_tile_raster_fwd_seeded" + ("_train" if train else "")
    out = _fwd_cuda(symbol, table, starts, counts, row_offset, cfg,
                    num_tiles, row_stride, t_init=t_init, train=train,
                    surfel=surfel)
    if num_tiles:
        tile_raster_fwd_seeded.launches += 1
    return out


tile_raster_fwd_seeded.launches = 0


def tile_raster_fwd_plain(table, starts, counts, row_offset,
                          cfg: RenderConfig, local_rows: int | None = None,
                          row_stride: int = 1, surfel: bool = False):
    """The plain PyTorch version of ``tile_raster_fwd`` (same signature,
    same results up to summation order)."""
    return tile_raster_fwd_seeded_plain(table, starts, counts, None,
                                        row_offset, cfg, local_rows,
                                        row_stride, surfel=surfel)


def tile_raster_fwd_train_plain(table, starts, counts, row_offset,
                                cfg: RenderConfig,
                                local_rows: int | None = None,
                                row_stride: int = 1, surfel: bool = False):
    """The plain PyTorch version of ``tile_raster_fwd_train``: T, ckpt and
    nproc equal the kernel's bit for bit, rgb up to summation order."""
    return tile_raster_fwd_seeded_plain(table, starts, counts, None,
                                        row_offset, cfg, local_rows,
                                        row_stride, train=True,
                                        surfel=surfel)


def tile_raster_fwd_seeded_plain(table, starts, counts, t_init, row_offset,
                                 cfg: RenderConfig,
                                 local_rows: int | None = None,
                                 row_stride: int = 1, train: bool = False,
                                 surfel: bool = False):
    """The plain PyTorch version of ``tile_raster_fwd_seeded`` (T, ckpt
    and nproc bit for bit, rgb up to summation order); ``t_init`` None is
    1.0, the plain B1 / B2."""
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, int(row_offset), row_stride,
                             device=table.device)
    ckpt = torch.zeros((ckpt_rows(px.shape[1]), table.shape[1]),
                       dtype=torch.float32, device=table.device) \
        if train else None
    rgb, trans, nproc = blend_tiles_plain(table, starts[:-1], counts, px, py,
                                          cfg, ckpt=ckpt, t_init=t_init,
                                          surfel=surfel)
    if train:
        return rgb, trans, ckpt, nproc.to(torch.int32)
    return rgb, trans


def fragments(rows, live, px, py, cfg: RenderConfig):
    """The kernels' fragment math for A tiles' rows against their pixels,
    in the kernels' expression order (so alpha is theirs bit for bit).

    rows: (11, A, R) attributes, live: (A, R), px/py: (A, P).  Returns
    (dx, dy, gauss, alpha, unclamped), each (A, R, P): gauss is all ones
    in billboard mode; unclamped (kept and op * gauss < alpha_clamp, where
    d alpha / d raw is 1) is None in billboard and ball modes.  Surfel
    rows (15 attributes) take ``surfel_fragments``."""
    if rows.shape[0] == binning.SURFEL_ATTRS:
        return surfel_fragments(rows, live, px, py, cfg)
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


def surfel_fragments(rows, live, px, py, cfg: RenderConfig):
    """``fragments`` of surfel rows (15, A, R) (2D Gaussian splatting,
    the official rasterizer's per-fragment code): at pixel (x, y) the
    planes k = x Tw - Tu and l = y Tw - Tv meet the disk's plane at p =
    k x l, skipped where p3 == 0; (u, v) = (p1 / p3, p2 / p3), rho3d =
    u^2 + v^2 and the low-pass rho2d = 2 |(cx, cy) - (x, y)|^2; rho =
    min(rho3d, rho2d), power = -rho / 2; skipped where the intersection's
    depth (u Tw1 + v Tw2 + Tw3 where rho3d <= rho2d, else Tw3) is under
    SURFEL_NEAR; alpha as 3DGS's.  Returns (None, None, gauss, alpha,
    unclamped): a surfel has no rect offsets."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    x, y = px[:, None, :], py[:, None, :]
    tu = [col(b.COL_TU + i) for i in range(3)]
    tv = [col(b.COL_TV + i) for i in range(3)]
    tw = [col(b.COL_TW + i) for i in range(3)]
    k = [x * tw[i] - tu[i] for i in range(3)]
    m = [y * tw[i] - tv[i] for i in range(3)]
    p1 = k[1] * m[2] - k[2] * m[1]
    p2 = k[2] * m[0] - k[0] * m[2]
    p3 = k[0] * m[1] - k[1] * m[0]
    hit = p3 != 0.0
    p3 = torch.where(hit, p3, torch.ones_like(p3))
    u = p1 / p3
    v = p2 / p3
    rho3d = u * u + v * v
    dx = col(b.COL_CX) - x
    dy = col(b.COL_CY) - y
    rho2d = 2.0 * (dx * dx + dy * dy)
    on_disk = rho3d <= rho2d
    rho = torch.where(on_disk, rho3d, rho2d)
    depth = torch.where(on_disk, u * tw[0] + v * tw[1] + tw[2], tw[2])
    power = -0.5 * rho
    gauss = fragment_exp(power)
    raw = col(b.COL_OPACITY) * gauss
    alpha = torch.clamp(raw, max=cfg.alpha_clamp)
    keep = live[:, :, None] & hit & (depth >= SURFEL_NEAR) \
        & (power <= 0.0) & (alpha >= cfg.alpha_min)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return None, None, gauss, alpha, keep & (raw < cfg.alpha_clamp)


def square_bands(tile_size: int) -> bool:
    """Whether the kernels' warp bands (B1, B2, B4 and B3 alike) are 8x8
    squares at ``tile_size``: at 32x32, where a 32x2 strip of tile rows
    keeps 1.5x the (row, band) pairs on the 1M frame; elsewhere they are
    ``band_rows`` whole tile rows."""
    return tile_size == 32


def band_rows(ts: int) -> int:
    """Tile rows of one warp band: BAND_PIXELS // ts rows (4 of a 16x16
    tile), or the whole tile where that does not divide it evenly."""
    rows = max(1, BAND_PIXELS // ts)
    return rows if ts % rows == 0 else ts


def warp_cull_plain(rows, live, px, py, square=False):
    """The (row, band) pairs the kernels keep: (A, R, bands) bool for A
    tiles' rows (11, A, R), live (A, R), and their pixel centres px / py
    (A, P), P = ts * ts; a band is ``band_rows(ts)`` tile rows (4 bands of
    4 rows in the kernels' 16x16 tile), or with ``square`` an 8x8 square
    (the kernels' bands at 32x32, ``square_bands``; row-major:
    ``band_of_pixel``).

    The kernels' own rect test, fabsf(px - cx) <= rx and fabsf(py - cy) <=
    ry, at each of the tile's ts column centres and each band's row
    centres: a band is the product of its columns and rows, so a row
    reaches one of its pixels iff it reaches one of its columns and one of
    its rows.  Outside the kept pairs every fragment has alpha == 0."""
    b = binning
    a_n, r_n = live.shape
    ts = int(round(px.shape[1] ** 0.5))
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    xs = px[:, None, :ts]                # the tile's column centres
    ys = py[:, None, ::ts]               # its row centres
    x_in = torch.abs(xs - col(b.COL_CX)) <= col(b.COL_RX)
    y_in = torch.abs(ys - col(b.COL_CY)) <= col(b.COL_RY)
    if square:
        x_hit = x_in.reshape(a_n, r_n, -1, SQUARE).any(dim=3)
        y_hit = y_in.reshape(a_n, r_n, -1, SQUARE).any(dim=3)
        kept = (y_hit[:, :, :, None] & x_hit[:, :, None, :]).flatten(2)
        return kept & live[:, :, None]
    x_hit = x_in.any(dim=2)
    y_hit = y_in.reshape(a_n, r_n, -1, band_rows(ts)).any(dim=3)
    return x_hit[:, :, None] & y_hit & live[:, :, None]


def band_of_pixel(ts: int, square=False, device="cpu"):
    """(P,) the band of each tile pixel (row-major): pixel p // BAND_PIXELS
    for row bands, the 8x8 square (y // 8) * (ts // 8) + x // 8 with
    ``square``."""
    p = torch.arange(ts * ts, device=device)
    if not square:
        return p // (band_rows(ts) * ts)
    return (p // ts // SQUARE) * (ts // SQUARE) + p % ts // SQUARE


def warp_cull_pixels(rows, live, px, py, square=False):
    """``warp_cull_plain`` spread over the pixels: (A, R, P) bool."""
    ts = int(round(px.shape[1] ** 0.5))
    return warp_cull_plain(rows, live, px, py, square)[
        :, :, band_of_pixel(ts, square, px.device)]


def _blend_window(rows, live, px, py, rgb, trans, cfg: RenderConfig,
                  n_first=None, cull=False):
    """Composite one window of rows into A tiles' accumulators.

    rows: (11, A, R) attributes, live: (A, R), px/py: (A, P),
    rgb: (A, P, 3), trans: (A, P).  Transmittance is the sequential product
    T, T(1-a_0), T(1-a_0)(1-a_1), ... (cumprod along a non-innermost dim is
    a sequential loop on both CPU and CUDA), so T matches the kernel's
    per-thread loop bit for bit; only the rgb sums are taken in another
    order.  With ``cull`` the alpha and weight of every fragment outside
    the pairs ``warp_cull_plain`` keeps (with the kernels' bands,
    ``square_bands``) are zeroed, as the kernels skip them.  Returns (rgb,
    exit T, T after the first ``n_first`` (A,) rows or None)."""
    b = binning
    col = lambda c: rows[c][:, :, None]  # noqa: E731  (A, R, 1)
    _, _, gauss, alpha, _ = fragments(rows, live, px, py, cfg)
    if cull:
        zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
        kept = warp_cull_pixels(
            rows, live, px, py,
            square_bands(int(round(px.shape[1] ** 0.5))))
        alpha = torch.where(kept, alpha, zero)
    seq = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha], dim=1),
                        dim=1)
    weight = alpha * seq[:, :-1]
    if cfg.mode == RenderMode.GAUSSIAN_BALL:
        weight = weight * gauss
    if cull:
        weight = torch.where(kept, weight, zero)
    rgb = rgb + torch.stack(
        [(weight * col(c)).sum(dim=1) for c in (b.COL_R, b.COL_G, b.COL_BCH)],
        dim=-1,
    )
    t_first = None
    if n_first is not None:
        t_first = seq[torch.arange(seq.shape[0], device=seq.device), n_first]
    return rgb, seq[:, -1], t_first


def _put_ckpt(ckpt, cols, t_blk):
    """ckpt[p // 128, c + p % 128] = t_blk[:, p] for each column c (a tile
    of under 128 pixels fills the rest of its row with zeros)."""
    a = cols.shape[0]
    if a == 0:
        return
    idx = cols[:, None] + torch.arange(SCAN_BLOCK, device=cols.device)
    t_blk = torch.nn.functional.pad(
        t_blk, (0, ckpt.shape[0] * SCAN_BLOCK - t_blk.shape[1]))
    ckpt[:, idx] = t_blk.reshape(a, -1, SCAN_BLOCK).permute(1, 0, 2)


def blend_tiles_plain(table, start, count, px, py, cfg: RenderConfig,
                      ckpt=None, t_init=None, cull=False, surfel=False):
    """Blend any set of tiles: start/count (K,) their table segments,
    px/py (K, P) their pixel centres, t_init (K, P) their entering
    transmittance (None: 1.0).  Returns rgb (K, P, 3), trans (K, P) and
    the windows each tile processed (K,) int64.

    Mirrors the kernel: 256-row windows aligned to 128 rows, the tile-wide
    stop after each window.  Tiles go in bounded groups so memory stays
    bounded; within a window only each tile's live rows are evaluated (dead
    rows have alpha 0, which leaves T and rgb exactly unchanged).  With
    ``ckpt`` given, each window also writes the checkpoints kernel B2
    writes: the T leaving each 128-row block at the next block's columns,
    where that block holds a live row of the tile.  ``cull`` skips the
    fragments the kernels' warp cull skips (``_blend_window``); the result
    is the same bits.  ``surfel``: a surfel table, blended with
    ``surfel_fragments`` and no cull (the kernels' surfel band cull is
    exact)."""
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
    attrs = table[: binning.SURFEL_ATTRS if surfel else binning.BLEND_ATTRS]
    cull = cull and not surfel
    rgb = torch.zeros((K, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((K, P), dtype=torch.float32, device=dev) \
        if t_init is None else t_init.clone()
    nproc = torch.zeros((K,), dtype=torch.int64, device=dev)
    group = max(1, PLAIN_ELEMS.get(dev.type, 1 << 22) // (chunk * P))
    for g0 in range(0, K, group):
        ids = torch.arange(g0, min(g0 + group, K), device=dev)
        # the kernel tests the stop before every window, the first included
        # (it can fire there only when seeded)
        act = ids[(nchunks[ids] > 0) & (
            trans[ids].amax(dim=1) > cfg.early_stop_transmittance)]
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
                cfg, n_first, cull)
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
