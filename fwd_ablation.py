#!/usr/bin/env python3
"""Ablation of the blend forward (kernels B1, B2 and B4, one template in
gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu) on one CUDA card.

  python3 fwd_ablation.py [--tiles 8,16,32] [--no-garden] [--base PATH.cu]
                          [--source NAME=PATH.cu ...]

Builds the source as it is ("base", or --base) and variants of it, each
with one step of the design switched off or replaced by a text patch,
plus any other source of the same C interface named with --source (the
parent's, say: `git show
REV:gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu`), all
nvcc processes started together, and times each with CUDA events on real
inputs at each of --tiles: B1 and B2 on the 1M-splat 1920x1080 table
(chip_smoke.py phases 4, 4b, 5 and 5b) and B4 (inference) on the fused
serving path's pass-2 inputs (phase 4b's prefix); at 16 also B4 (train
variant) on the 1M table entering with a seeded transmittance, B2 on the
garden step's pass-1 table and B4 on its pass-2 table (phase 9; left out
with --no-garden).  Every variant and every --source computes the same
function, so each is held bit for bit to base in rgb, T, nproc and ckpt
on every input and to its own second launch (but the timing-only
variants, whose results are discarded); base is held to the plain
version (rgb within 1e-5 * max(1, |plain|), the rest equal).  The
clock-probe variant gives the spread of the CTAs' times, the tail after
the last CTA started and the warps resident per SM.  Also prints each
variant's registers, shared memory and CTAs per SM as built and, over a
sample of tiles, the share of blended (row, band) pairs the warp cull
keeps and how evenly the bands share a window's kept rows, at 32 for
32x2 strips and for 8x8 squares.  Needs the card and nvcc; imports no
JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import bwd_ablation as ba
import chip_smoke as cs

# scalar staging: a row's 11 attributes read with 11 scalar shared loads
_SHAPE = '''    const float4 q0 = s[0], q1 = s[1];
    cx = q0.x; cy = q0.y; a = q0.z; b = q0.w;
    c = q1.x; op = q1.y; rx = q1.z; ry = q1.w;
'''
_SHAPE_SCALAR = '''    const volatile float* f = reinterpret_cast<const volatile float*>(s);
    cx = f[0]; cy = f[1]; a = f[2]; b = f[3];
    c = f[4]; op = f[5]; rx = f[6]; ry = f[7];
'''
_COLOUR = '''    const float4 q = s[2];
    r = q.x; g = q.y; b = q.z;
'''
_COLOUR_SCALAR = '''    const volatile float* f = reinterpret_cast<const volatile float*>(s);
    r = f[8]; g = f[9]; b = f[10];
'''
_COLUMN = '''  const float dx = px - q.cx;
  const float adxdx = q.a * dx * dx;
  const float bdx = q.b * dx;
  const bool x_in = fabsf(dx) <= q.rx;
  float alpha[kPix], gauss[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float dy = py[i] - q.cy;
'''
_COLUMN_PER_PIXEL = '''  float alpha[kPix], gauss[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float dx = px[i] - q.cx;
    const float adxdx = q.a * dx * dx;
    const float bdx = q.b * dx;
    const bool x_in = fabsf(dx) <= q.rx;
    const float dy = py[i] - q.cy;
'''
_PX = '''  const float px =
      tx * kTile + static_cast<float>(pixel_of<TILE>(warp, lane, 0) % kTile) +
      0.5f;
'''
# a copy of px per pixel that the compiler cannot prove equal (a shuffle
# from the thread's own lane), so nothing of the column is shared
_PX_PER_PIXEL = '''  float px[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    px[i] = __shfl_sync(kFull, tx * kTile + static_cast<float>(
        pixel_of<TILE>(warp, lane, 0) % kTile) + 0.5f, lane + 32 * i);
  }
'''
_ONE_ROW = '''      blend_row<MODE>(&sm.rows[j * 3], px, py, prm, T, acc);
'''
_TWO_ROWS = '''      if (m) {
        const int j1 = s0 + __ffs(m) - 1;
        m &= m - 1;
        blend_row<MODE>(&sm.rows[j * 3], px, py, prm, T, acc);
        blend_row<MODE>(&sm.rows[j1 * 3], px, py, prm, T, acc);
      } else {
        blend_row<MODE>(&sm.rows[j * 3], px, py, prm, T, acc);
      }
'''
# warp w holds the 8x8 quadrant (w % 2, w / 2) of the tile: lane l column
# l % 8, rows l / 8 and l / 8 + 4 (still one column per thread)
_QUADRANT_PIXEL = ('  return warp * 32 * kPix + i * 32 + lane;',
                   '  return ((warp / 2) * 8 + lane / 8 + 4 * i) * 16'
                   ' + (warp % 2) * 8 + lane % 8;')
# variants whose geometry holds at 16x16 only (a warp count of 0 or above
# 16 at 8x8 or 32x32, or quadrants) leave out the other sizes' kernels
_ONLY_16 = [
    ("    if (tile == 8) return by_mode<8, TRAIN, SEEDED>(mode, f);\n", ""),
    ("    if (tile == 32) return by_mode<32, TRAIN, SEEDED>(mode, f);\n", "")]
_BAND_MASK = '''  bool x_hit = false;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const float px = tx * kTile + static_cast<float>(k) + 0.5f;
    x_hit |= fabsf(px - cx) <= rx;
  }
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bool y_hit = false;
#pragma unroll
    for (int y = 0; y < kBandRows; ++y) {
      const float py =
          ty * kTile + static_cast<float>(w * kBandRows + y) + 0.5f;
      y_hit |= fabsf(py - cy) <= ry;
    }
    m |= (x_hit && y_hit) ? 1u << w : 0u;
  }
  return m;
}
'''
_QUADRANT_MASK = '''  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bool x_hit = false, y_hit = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float px = tx * kTile + static_cast<float>((w % 2) * 8 + k) + 0.5f;
      const float py = ty * kTile + static_cast<float>((w / 2) * 8 + k) + 0.5f;
      x_hit |= fabsf(px - cx) <= rx;
      y_hit |= fabsf(py - cy) <= ry;
    }
    m |= (x_hit && y_hit) ? 1u << w : 0u;
  }
  return m;
}
'''


# the CTA clock probe: thread 0 of each CTA writes, after a barrier at the
# kernel's end, its SM, its start and end on the global timer (low 32
# bits, ns), its SM clock cycles and a 1.0f into a device buffer that
# gsv_probe_read copies out (rows of bwd_ablation.probe_report's layout)
_PROBE = [
    ("// TRAIN = false is kernel B1, TRAIN = true kernel B2",
     "constexpr int kProbeMax = 1 << 16;\n"
     "__device__ int gsv_probe_buf[5 * kProbeMax];\n\n"
     "// TRAIN = false is kernel B1, TRAIN = true kernel B2"),
    ("  const int t = blockIdx.x;\n",
     "  long long probe_t0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_t0));\n"
     "  const long long probe_c0 = clock64();\n"
     "  const int t = blockIdx.x;\n"),
    ("  if (TRAIN && tid == 0) out_nproc[t] = ci;\n}",
     "  if (TRAIN && tid == 0) out_nproc[t] = ci;\n"
     "  __syncthreads();\n"
     "  if (tid == 0 && t < kProbeMax) {\n"
     "    long long t1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
     "    const long long c1 = clock64();\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    gsv_probe_buf[t] = static_cast<int>(smid);\n"
     "    gsv_probe_buf[kProbeMax + t] =\n"
     "        static_cast<int>(static_cast<unsigned>(probe_t0));\n"
     "    gsv_probe_buf[2 * kProbeMax + t] =\n"
     "        static_cast<int>(static_cast<unsigned>(t1));\n"
     "    gsv_probe_buf[3 * kProbeMax + t] = static_cast<int>(c1 - probe_c0);\n"
     "    gsv_probe_buf[4 * kProbeMax + t] = __float_as_int(1.0f);\n"
     "  }\n"
     "}"),
    ('extern "C" const char* gsv_cuda_error_string(int code) {',
     'extern "C" int gsv_probe_read(int* dst, int n) {\n'
     "  for (int k = 0; k < 5; ++k) {\n"
     "    const cudaError_t e = cudaMemcpyFromSymbol(\n"
     "        dst + k * n, gsv_probe_buf, n * sizeof(int),\n"
     "        k * kProbeMax * sizeof(int));\n"
     "    if (e != cudaSuccess) return static_cast<int>(e);\n"
     "  }\n"
     "  return 0;\n"
     "}\n\n"
     'extern "C" const char* gsv_cuda_error_string(int code) {')]
# double-buffered windows: two windows' shared memory; window ci + 1 is
# staged into the other buffer before window ci is blended, so one barrier
# per window (the stop test's) orders both the staging and the reuse
_DOUBLE_BUFFER = [
    ("  __shared__ Smem<TILE> sm;\n", "  __shared__ Smem<TILE> smb[2];\n"),
    ("  int ci = 0;\n  for (; ci < num_chunks; ++ci) {\n",
     "  if constexpr (G::kStageRows == kChunk) {\n"
     "    if (num_chunks > 0) {\n"
     "      stage_rows<TILE>(smb[0], table, dpad, base, start, end, tid, tx,"
     " ty);\n"
     "    }\n"
     "  }\n"
     "  int ci = 0;\n  for (; ci < num_chunks; ++ci) {\n"),
    ("    const int w0 = base + ci * kChunk;\n",
     "    const int w0 = base + ci * kChunk;\n"
     "    Smem<TILE>& sm = smb[ci & 1];\n"),
    ("      stage_rows<TILE>(sm, table, dpad, w0, start, end, tid, tx, ty);\n"
     "      __syncthreads();\n",
     "      if (ci + 1 < num_chunks) {\n"
     "        stage_rows<TILE>(smb[(ci + 1) & 1], table, dpad, w0 + kChunk,"
     " start,\n"
     "                         end, tid, tx, ty);\n"
     "      }\n"),
]
PROBE_MAX = 1 << 16

# name: (text patches, what is held, tile sizes or None for all), as in
# bwd_ablation.py.  Held: "bits" equal to base and to its own second
# launch, "probe" as "bits" plus the probe's report, None nothing (timing
# only: what a step costs).  A variant whose patch target is not in the
# source is skipped.
VARIANTS = {
    "base": ([], "bits", None),
    "no warp cull": ([("  return m;\n}", "  return (1u << kWarps) - 1;\n}"),
                      (("    return m;\n  }\n", None),
                       "    return (1u << kWarps) - 1;\n  }\n")],
                     "bits", None),
    "scalar staging (11 shared loads per row)": (
        [(_SHAPE, _SHAPE_SCALAR), (_COLOUR, _COLOUR_SCALAR)], "bits",
        (16,)),
    "no shared column term": ([
        (_COLUMN, _COLUMN_PER_PIXEL), (_PX, _PX_PER_PIXEL),
        ("blend_row(const float4* row, float px,",
         "blend_row(const float4* row, const float (&px)[kPix],"),
        ("                                           float px, const float",
         "                                           const float (&px)[kPix],"
         " const float")], "bits", (16,)),
    "rows two at a time": ([(_ONE_ROW, _TWO_ROWS)], "bits", None),
    "1 pixel per thread": ([("constexpr int kPix = 2;",
                             "constexpr int kPix = 1;"), *_ONLY_16], "bits",
                           (16,)),
    "4 pixels per thread": ([("constexpr int kPix = 2;",
                              "constexpr int kPix = 4;"), *_ONLY_16],
                            "bits", (16,)),
    "8x8 quadrants per warp": (
        [_QUADRANT_PIXEL, (_BAND_MASK, _QUADRANT_MASK), *_ONLY_16], "bits",
        (16,)),
    "6 CTAs per SM (launch bounds)": (
        [("constexpr int kMinCtas = 32 / kWarps;",
          "constexpr int kMinCtas = 24 / kWarps;"), *_ONLY_16], "bits",
        (16,)),
    "10 CTAs per SM (launch bounds)": (
        [("constexpr int kMinCtas = 32 / kWarps;",
          "constexpr int kMinCtas = 40 / kWarps;"), *_ONLY_16], "bits",
        (16,)),
    "CTA clock probe": (_PROBE, "probe", None),
    "no window barriers (timing only)": (
        [("    if (!__syncthreads_or(live)) break;",
          "    if (!__any_sync(kFull, live)) break;"),
         (("      __syncthreads();\n      const int lo = max(start - w0, 0);",
           None), "      const int lo = max(start - w0, 0);"),
         (("    __syncthreads();\n    const int lo = max(start - w0, 0);",
           None), "    const int lo = max(start - w0, 0);")], None, None),
    "tile 32: 32x2 bands (the parent's)": (
        [("kSquare = TILE == 32;", "kSquare = false;")], "bits", (32,)),
    "tile 32: double-buffered windows": (_DOUBLE_BUFFER, "bits", (32,)),
    "tile 8: 256-row windows staged (the parent's)": (
        [("kStageRows = TILE == 8 ? kAlign : kChunk", "kStageRows = kChunk")],
        "bits", (8,)),
}


def probe_rows(lib, n, dev):
    """The clock probe's rows for the last launch's n CTAs, laid out as
    bwd_ablation.probe_report reads them (rows 9-13 of a (14, n) f32)."""
    buf = (ctypes.c_int * (5 * n))()
    lib.gsv_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsv_probe_read.restype = ctypes.c_int
    torch.cuda.synchronize()
    rc = lib.gsv_probe_read(ctypes.addressof(buf), n)
    if rc:
        raise RuntimeError(f"gsv_probe_read: CUDA error {rc}")
    g = torch.zeros((14, n), dtype=torch.float32)
    g[9:14] = torch.from_numpy(
        np.ctypeslib.as_array(buf).reshape(5, n).view(np.float32).copy())
    return g.to(dev)


def inputs(dev, ts, garden):
    """{tag: (wrapper, args, kwargs, tiles)} of the timed launches at tile
    size ``ts``; prints the cull's shares on the 1M step's table."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.ops import binning, fused
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    cfg = RenderConfig(width=cs.FULL_W, height=cs.FULL_H, tile_size=ts)
    splats = ba.full_splats(dev, cfg)
    with torch.no_grad():
        bs = binning.bin_splats(splats, cfg)
        table = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        _, _, _, nproc = b1.tile_raster_fwd_train(*table)
        for square in (False, True) if ts == 32 else (False,):
            ba.shares(f"1M step tile {ts}"
                      + (", 8x8 square bands" if square else ""),
                      bs.table, bs.tile_starts, nproc, cfg, sizes=(256,),
                      square=square)
        cf = cs.fused_serving(cfg, cs.FULL_PREFIX[ts])
        pres = binning.bin_splats_presort(splats, cf)
        f = fused._forward(cf, cf.tiles_y, 1, pres.table_src,
                           pres.rows_sorted, pres.starts_full, 0,
                           train=False)
        del pres, splats
    nt = cfg.num_tiles
    runs = {
        f"B1 1M frame t{ts}": (b1.tile_raster_fwd, table, {}, nt),
        f"B2 1M step t{ts}": (b1.tile_raster_fwd_train, table, {}, nt),
        f"B4 1M fused pass 2 t{ts}": (
            b1.tile_raster_fwd_seeded,
            (f["table2"], f["rstarts_c"], f["rcounts"], f["trans1"], 0, cf),
            {}, nt),
    }
    if ts != 16:
        return runs
    gen = torch.Generator(device="cpu").manual_seed(5)
    t_init = 0.2 + 0.8 * torch.rand((nt, 256), generator=gen)
    t_init[::7] = 5e-5  # some tiles enter saturated
    runs["B4 1M seeded (train)"] = (
        b1.tile_raster_fwd_seeded, (bs.table, bs.tile_starts,
                                    bs.tile_counts, t_init.to(dev), 0, cfg),
        {"train": True}, nt)
    if garden:
        g, gcfg = ba.garden_passes(dev)
        with torch.no_grad():
            ba.shares("garden pass 1", g["table1"], g["pstarts_c"],
                      g["nproc1"], gcfg, sizes=(256,))
        runs["B2 garden pass 1"] = (
            b1.tile_raster_fwd_train,
            (g["table1"], g["pstarts_c"], g["pcounts"], 0, gcfg), {},
            gcfg.num_tiles)
        runs["B4 garden pass 2"] = (
            b1.tile_raster_fwd_seeded,
            (g["table2"], g["rstarts_c"], g["rcounts"], g["trans1"], 0,
             gcfg), {"train": True}, gcfg.num_tiles)
    return runs


def plain_of(fn):
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    return {b1.tile_raster_fwd: b1.tile_raster_fwd_plain,
            b1.tile_raster_fwd_train: b1.tile_raster_fwd_train_plain,
            b1.tile_raster_fwd_seeded: b1.tile_raster_fwd_seeded_plain}[fn]


def hold_to_plain(tag, out, plain):
    """rgb within 1e-5 * max(1, |plain|); T, ckpt and nproc equal."""
    err = float((out[0] - plain[0]).abs().max()) if out[0].numel() else 0.0
    tol = 1e-5 * max(1.0, float(plain[0].abs().max())
                     if plain[0].numel() else 0.0)
    same = all(torch.equal(a, b) for a, b in zip(out[1:], plain[1:]))
    cs.log(f"[plain] {tag}: base rgb max|diff| {err:.3e} (tol {tol:.1e}), "
           f"T/ckpt/nproc equal {same}")
    if not (err <= tol and same):
        raise AssertionError(f"{tag}: base disagrees with the plain version")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Ablation of kernels B1, B2 and B4.")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another tile_raster_fwd.cu as NAME (held "
                         "bit-equal to base)")
    ap.add_argument("--base", metavar="PATH",
                    help="patch and time this tile_raster_fwd.cu as base "
                         "(default: the checkout's)")
    ap.add_argument("--tiles", default="8,16,32",
                    help="tile sizes to time at (comma-separated)")
    ap.add_argument("--no-garden", action="store_true",
                    help="leave out the garden passes (timed at 16)")
    args = ap.parse_args(argv)
    tiles = [int(x) for x in args.tiles.split(",")]
    variants = dict(VARIANTS)
    sources = {"base": Path(args.base).read_text()} if args.base else {}
    for item in args.source:
        name, path = item.split("=", 1)
        variants[name] = ([], "bits", None)
        sources[name] = Path(path).read_text()
    if not torch.cuda.is_available():
        print("fwd_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gaussiansplattingviewer_tpu_torch.config import RenderMode
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    dev = torch.device("cuda")
    cs.log("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = ba.build_variants(Path(tmp), sources, variants,
                                 "tile_raster_fwd")
        for name in libs:
            build._LIBS["tile_raster_fwd"] = libs[name]
            for ts in tiles:
                if variants[name][2] and ts not in variants[name][2]:
                    continue
                for kernel, kw in (("B1", {}), ("B2", {"train": True})):
                    occ = b1.kernel_occupancy(RenderMode.SH3, tile_size=ts,
                                              **kw)
                    cs.log(f"[occupancy] {name} tile {ts} {kernel} SH3: "
                           f"{occ}")
        for ts in tiles:
            runs = inputs(dev, ts, not args.no_garden)
            base = {}
            for rnd in range(2):
                for name, (_, held, only) in variants.items():
                    if name not in libs or (only and ts not in only):
                        continue
                    build._LIBS["tile_raster_fwd"] = libs[name]
                    times, same, again = [], True, True
                    for tag, (fn, a, kw, ntiles) in runs.items():
                        fn(*a, **kw)  # warm-up
                        ms, out = cs.cuda_ms(lambda: fn(*a, **kw), 10)
                        times.append(f"{tag} {ms:.3f} ms")
                        if held == "probe":
                            ba.probe_report(
                                f"{tag} round {rnd}",
                                probe_rows(libs[name], ntiles, dev), ms,
                                ntiles * ts * ts // b1.BAND_PIXELS)
                        if not held:
                            continue
                        if tag not in base:
                            base[tag] = [o.clone() for o in out]
                            hold_to_plain(tag, out, plain_of(fn)(*a, **kw))
                        same &= all(torch.equal(x, y)
                                    for x, y in zip(out, base[tag]))
                        again &= all(torch.equal(x, y)
                                     for x, y in zip(out, fn(*a, **kw)))
                    note = (f"; bit-equal to base in rgb, T, ckpt, nproc "
                            f"{same}, to its own second launch {again}"
                            if held else " (timing only)")
                    cs.log(f"[ablate] tile {ts} round {rnd} {name}: "
                           + ", ".join(times) + note)
                    if not (same and again):
                        raise AssertionError(
                            f"{name} changed the function at tile {ts}")
            del runs, base
            torch.cuda.empty_cache()
        build._LIBS.pop("tile_raster_fwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
