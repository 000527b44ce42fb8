#!/usr/bin/env python3
"""Ablation of the blend forward (kernels B1, B2 and B4, one template in
gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu) on one CUDA card.

  python3 fwd_ablation.py [--source NAME=PATH.cu ...]

Builds the source as it is ("base") and variants of it, each with one step
of the design switched off by a text patch, plus any other source of the
same C interface named with --source (an earlier version of the file, say:
`git show REV:gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu`),
and times each with CUDA events on real inputs: B1 and B2 on the 1M-splat
1920x1080 table (chip_smoke.py phases 4 and 5), B4 (train variant) on the
same table entering with a seeded transmittance, B2 on the garden step's
pass-1 table and B4 on its pass-2 table (phase 8).  Every variant and every
--source computes the same function, so each is held bit for bit to base
in rgb, T, nproc and ckpt on every input; base is held to the plain
version (rgb within 1e-5 * max(1, |plain|), the rest equal).  Also prints,
over a sample of tiles, the share of blended (row, band) pairs the warp
cull keeps and how evenly the 4 bands share a window's lit rows.  Needs
the card and nvcc; imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

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
      tx * kTile + static_cast<float>(pixel_of(warp, lane, 0) % kTile) + 0.5f;
'''
# a copy of px per pixel that the compiler cannot prove equal (a shuffle
# from the thread's own lane), so nothing of the column is shared
_PX_PER_PIXEL = '''  float px[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    px[i] = __shfl_sync(kFull, tx * kTile + static_cast<float>(
        pixel_of(warp, lane, 0) % kTile) + 0.5f, lane + 32 * i);
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
                   '  return ((warp / 2) * 8 + lane / 8 + 4 * i) * kTile'
                   ' + (warp % 2) * 8 + lane % 8;')
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


# name: (text patches, what is held): as in bwd_ablation.py; every variant
# computes the same function, so each is held bit-equal to base
VARIANTS = {
    "base": ([], "bits"),
    "no warp cull": ([("  return m;\n}", "  return (1u << kWarps) - 1;\n}")],
                     "bits"),
    "scalar staging (11 shared loads per row)": (
        [(_SHAPE, _SHAPE_SCALAR), (_COLOUR, _COLOUR_SCALAR)], "bits"),
    "no shared column term": ([
        (_COLUMN, _COLUMN_PER_PIXEL), (_PX, _PX_PER_PIXEL),
        ("blend_row(const float4* row, float px,",
         "blend_row(const float4* row, const float (&px)[kPix],"),
        ("                                           float px, const float",
         "                                           const float (&px)[kPix],"
         " const float")], "bits"),
    "rows two at a time": ([(_ONE_ROW, _TWO_ROWS)], "bits"),
    "1 pixel per thread": ([("constexpr int kPix = 2;",
                             "constexpr int kPix = 1;")], "bits"),
    "4 pixels per thread": ([("constexpr int kPix = 2;",
                              "constexpr int kPix = 4;")], "bits"),
    "8x8 quadrants per warp": (
        [_QUADRANT_PIXEL, (_BAND_MASK, _QUADRANT_MASK)], "bits"),
    "6 CTAs per SM (launch bounds)": (
        [("constexpr int kMinCtas = 32 / kWarps;",
          "constexpr int kMinCtas = 24 / kWarps;")], "bits"),
    "10 CTAs per SM (launch bounds)": (
        [("constexpr int kMinCtas = 32 / kWarps;",
          "constexpr int kMinCtas = 40 / kWarps;")], "bits"),
}


def inputs(dev):
    """{tag: (wrapper, args, kwargs)} of the timed launches."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    bs, cfg = ba.full_table(dev)
    table = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
    with torch.no_grad():
        _, _, _, nproc = b1.tile_raster_fwd_train(*table)
        ba.shares("1M frame", bs.table, bs.tile_starts, nproc, cfg,
                  sizes=(256,))
    gen = torch.Generator(device="cpu").manual_seed(5)
    t_init = 0.2 + 0.8 * torch.rand((cfg.num_tiles, 256), generator=gen)
    t_init[::7] = 5e-5  # some tiles enter saturated
    seeded = (bs.table, bs.tile_starts, bs.tile_counts, t_init.to(dev), 0,
              cfg)

    f, gcfg = ba.garden_passes(dev)
    with torch.no_grad():
        ba.shares("garden pass 1", f["table1"], f["pstarts_c"], f["nproc1"],
                  gcfg, sizes=(256,))
    return {
        "B1 1M frame": (b1.tile_raster_fwd, table, {}),
        "B2 1M step": (b1.tile_raster_fwd_train, table, {}),
        "B4 1M seeded": (b1.tile_raster_fwd_seeded, seeded,
                         {"train": True}),
        "B2 garden pass 1": (b1.tile_raster_fwd_train,
                             (f["table1"], f["pstarts_c"], f["pcounts"], 0,
                              gcfg), {}),
        "B4 garden pass 2": (b1.tile_raster_fwd_seeded,
                             (f["table2"], f["rstarts_c"], f["rcounts"],
                              f["trans1"], 0, gcfg), {"train": True}),
    }


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
    args = ap.parse_args(argv)
    sources = {}
    for item in args.source:
        name, path = item.split("=", 1)
        VARIANTS[name] = ([], "bits")
        sources[name] = Path(path).read_text()
    if not torch.cuda.is_available():
        print("fwd_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    cs.log("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = ba.build_variants(Path(tmp), sources, VARIANTS,
                                 "tile_raster_fwd")
        runs = inputs(dev)
        base = {}
        for rnd in range(2):
            for name in VARIANTS:
                build._LIBS["tile_raster_fwd"] = libs[name]
                times, same = [], True
                for tag, (fn, a, kw) in runs.items():
                    fn(*a, **kw)  # warm-up
                    ms, out = cs.cuda_ms(lambda: fn(*a, **kw), 10)
                    times.append(f"{tag} {ms:.3f} ms")
                    if tag not in base:
                        base[tag] = [o.clone() for o in out]
                        hold_to_plain(tag, out, plain_of(fn)(*a, **kw))
                    same &= all(torch.equal(x, y)
                                for x, y in zip(out, base[tag]))
                cs.log(f"[ablate] round {rnd} {name}: " + ", ".join(times)
                       + f"; bit-equal to base in rgb, T, ckpt, nproc {same}")
                if not same:
                    raise AssertionError(f"{name} changed the function")
        build._LIBS.pop("tile_raster_fwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
