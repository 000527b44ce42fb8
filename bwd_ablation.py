#!/usr/bin/env python3
"""Ablation of the blend backward (kernels B3 and B5, one template in
gaussiansplattingviewer_tpu_torch/csrc/tile_raster_bwd.cu) on one CUDA card.

  python3 bwd_ablation.py [--tiles 8,16,32] [--no-garden] [--base PATH.cu]
                          [--source NAME=PATH.cu ...]

Builds the source as it is ("base", or --base) and variants of it, each
with one step of the design switched off, done twice or replaced by a
text patch, plus any other source of the same C interface named with
--source (the parent's, say), and times each with CUDA events on real
inputs: B3 on the 1M-splat training step's table and cotangents at each
of --tiles (chip_smoke.py phases 5 and 5b) and B5 on the garden step's
pass-1 table (phase 9; left out with --no-garden).  Variants that keep
the function are held bit-equal to base and to their own second launch
and within 1e-5 of max|plain column| of the plain version; the
timing-only variants (results discarded) show what a step costs.  The
clock-probe variant gives the spread of the CTAs' times, the tail after
the last CTA started and the warps resident per SM.  Also prints, over a
sample of tiles, the shares of blended (row, band) pairs the warp cull
keeps and that have a lit pixel, and how evenly the bands share the rows
of a sub-block and of a block.  Needs the card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

# variants timed at 16x16 only leave out B3's other tile sizes
_ONLY_16 = [
    ("    if (tile == 8) return by_mode<8, FUSED>(mode, f);\n", ""),
    ("    if (tile == 32) return by_mode<32, FUSED>(mode, f);\n", "")]
# the CTA clock probe: thread 0 of each CTA writes, after a barrier at the
# kernel's end, its SM, its start and end on the global timer (low 32 bits,
# ns), its SM clock cycles and a 1 into rows 9-13 of B3's g_table at column
# blockIdx.x (rows B3 leaves 0); rows 0-8 are held bit-equal to base
_PROBE = [
    ("  const int t = blockIdx.x",
     "  long long probe_t0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_t0));\n"
     "  const long long probe_c0 = clock64();\n"
     "  const int t = blockIdx.x"),
    ("}\n\n// Call f(kernel, threads, shared bytes",
     "  __syncthreads();\n"
     "  if (!FUSED && threadIdx.x == 0) {\n"
     "    long long t1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
     "    const long long c1 = clock64();\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    const int64_t b = blockIdx.x;\n"
     "    g_out[9 * gstride + b] = __int_as_float(static_cast<int>(smid));\n"
     "    g_out[10 * gstride + b] = __int_as_float(\n"
     "        static_cast<int>(static_cast<unsigned>(probe_t0)));\n"
     "    g_out[11 * gstride + b] = __int_as_float(\n"
     "        static_cast<int>(static_cast<unsigned>(t1)));\n"
     "    g_out[12 * gstride + b] = __int_as_float(\n"
     "        static_cast<int>(c1 - probe_c0));\n"
     "    g_out[13 * gstride + b] = 1.0f;\n"
     "  }\n"
     "}\n\n// Call f(kernel, threads, shared bytes")]
# 32x32 as a thread block cluster of 4 CTAs of 4 warps (4 CTAs per SM),
# with the forward's 32x2 bands and one band-sum buffer (the design before
# square bands): CTA r holds bands 4r .. 4r + 3; each sub-block's 16 band
# sums are read
# across the cluster (distributed shared memory) in ascending band order,
# so the function is base's bit for bit; the split cluster barrier pairs
# an arrive after the read with a wait before the next sums are written
_CLUSTER32 = [
    ("#include <cuda_runtime.h>\n",
     "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
    ("  static constexpr int kThreads = kPixels / kPix;  // 32, 128, 512\n"
     "  static constexpr int kWarps = kThreads / 32;     // one band of rows "
     "each\n"
     "  static constexpr int kBandRows = kTile / kWarps;  // 8, 4, 2 rows\n",
     "  static constexpr int kCtas = TILE == 32 ? 4 : 1;\n"
     "  static constexpr int kBands = kPixels / (32 * kPix);\n"
     "  static constexpr int kThreads = kPixels / kPix / kCtas;\n"
     "  static constexpr int kWarps = kThreads / 32;\n"
     "  static constexpr int kBandRows = kTile / kBands;\n"),
    ("  static_assert(kWarps * 32 * kPix == kPixels && kBandRows * kWarps == "
     "kTile,",
     "  static_assert(kBands * 32 * kPix == kPixels && kBandRows * kBands == "
     "kTile,"),
    ("kSumBufs = TILE == 32 ? 2 : 1", "kSumBufs = 1"),
    ("kSquare = TILE == 32;", "kSquare = false;"),
    ("                                              float ry, float tx, "
     "float ty) {",
     "                                              float ry, float tx, "
     "float ty, int band0) {"),
    ("static_cast<float>(w * kBandRows + y) + 0.5f;",
     "static_cast<float>((band0 + w) * kBandRows + y) + 0.5f;"),
    *((f"\n{pad}m = band_mask<TILE>(v[kCx], v[kCy], v[kRx], v[kRy], tx, "
       f"ty);", f"\n{pad}m = band_mask<TILE>(v[kCx], v[kCy], v[kRx], v[kRy], "
       f"tx, ty,\n{pad}                    rank * kWarps);")
      for pad in (" " * 10, " " * 12)),
    ("// FUSED = false is kernel B3; FUSED = true kernel B5, which also reads",
     "__device__ __forceinline__ void cluster_arrive() {\n"
     "  asm volatile(\"barrier.cluster.arrive.release;\" ::: \"memory\");\n"
     "}\n"
     "__device__ __forceinline__ void cluster_wait() {\n"
     "  asm volatile(\"barrier.cluster.wait.acquire;\" ::: \"memory\");\n"
     "}\n\n"
     "// FUSED = false is kernel B3; FUSED = true kernel B5, which also reads"),
    ("  const int t = blockIdx.x;\n", "  const int t = blockIdx.x / G::kCtas;\n"),
    ("  const int warp = tid >> 5;\n",
     "  const int warp = tid >> 5;\n"
     "  int rank = 0;\n"
     "  if constexpr (G::kCtas > 1) {\n"
     "    rank = static_cast<int>(cooperative_groups::this_cluster()"
     ".block_rank());\n"
     "  }\n"
     "  const int band = rank * kWarps + warp;\n"),
    ("\n      p = warp * 64 + i * 32 + lane;",
     "\n      p = band * 64 + i * 32 + lane;"),
    ("\n          p = warp * 64 + i * 32 + lane;",
     "\n          p = band * 64 + i * 32 + lane;"),
    ("  int buf = 0;  // the band-sum buffer of the current sub-block\n",
     "  int buf = 0;  // the band-sum buffer of the current sub-block\n"
     "  if constexpr (G::kCtas > 1) cluster_arrive();\n"),
    ("        if (lane == 0) sm.hot[buf][warp] = hot;",
     "        if constexpr (G::kCtas > 1) cluster_wait();\n"
     "        if (lane == 0) sm.hot[buf][warp] = hot;"),
    ("        __syncthreads();\n        const int n = s1 - s0;",
     "        if constexpr (G::kCtas > 1) {\n"
     "          cluster_arrive();\n"
     "          cluster_wait();\n"
     "          constexpr int kItems = kSub * NG;\n"
     "          constexpr int kPer = (kItems + G::kCtas - 1) / G::kCtas;\n"
     "          const int idx = rank * kPer + tid;\n"
     "          if (tid < kPer && idx < kItems && idx % kSub < s1 - s0) {\n"
     "            const int jj = idx % kSub;\n"
     "            const int c = idx / kSub;\n"
     "            auto cluster = cooperative_groups::this_cluster();\n"
     "            float v = 0.0f;\n"
     "#pragma unroll\n"
     "            for (int r = 0; r < G::kCtas; ++r) {\n"
     "              const Smem<TILE>* o = cluster.map_shared_rank(&sm, r);\n"
     "#pragma unroll\n"
     "              for (int w = 0; w < kWarps; ++w) {\n"
     "                if ((o->hot[0][w] >> jj) & 1u) v += "
     "o->part[0][jj][c][w];\n"
     "              }\n"
     "            }\n"
     "            g_out[static_cast<int64_t>(G0 + c) * gstride + w0 + s0 + "
     "jj] = v;\n"
     "          }\n"
     "          cluster_arrive();\n"
     "          continue;\n"
     "        }\n"
     "        __syncthreads();\n        const int n = s1 - s0;"),
    ("      }\n    }\n  }\n}\n\n// Call f(kernel, threads, shared bytes",
     "      }\n    }\n  }\n"
     "  if constexpr (G::kCtas > 1) cluster_wait();\n"
     "}\n\n// Call f(kernel, threads, shared bytes"),
    ("    kernel<<<num_tiles, threads, smem, s>>>(",
     "    if (tile == 32) {\n"
     "      cudaLaunchConfig_t cfg = {};\n"
     "      cfg.gridDim = dim3(static_cast<unsigned>(num_tiles * 4));\n"
     "      cfg.blockDim = dim3(static_cast<unsigned>(threads));\n"
     "      cfg.dynamicSmemBytes = static_cast<size_t>(smem);\n"
     "      cfg.stream = s;\n"
     "      cudaLaunchAttribute attr[1];\n"
     "      attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "      attr[0].val.clusterDim.x = 4;\n"
     "      attr[0].val.clusterDim.y = 1;\n"
     "      attr[0].val.clusterDim.z = 1;\n"
     "      cfg.attrs = attr;\n"
     "      cfg.numAttrs = 1;\n"
     "      const cudaError_t e2 = cudaLaunchKernelEx(\n"
     "          &cfg, kernel, table, static_cast<int64_t>(dpad), starts,\n"
     "          counts, nproc, ckpt, row_offset, tiles_x, row_stride,\n"
     "          alpha_clamp, one_m_min, alpha_min, ball_threshold, g_rgb,\n"
     "          g_trans, out_trans, goff, suffix_init, t_entry,\n"
     "          static_cast<int64_t>(gstride), g_out);\n"
     "      if (e2 != cudaSuccess) return static_cast<int>(e2);\n"
     "      return static_cast<int>(cudaGetLastError());\n"
     "    }\n"
     "    kernel<<<num_tiles, threads, smem, s>>>("),
]
# name: (text patches, what is held, tile sizes or None for all).  Held:
# "bits" equal to base and within the plain version's tolerance, "plain"
# that tolerance only, "probe" rows 0-8 as "bits" (the clock probe), None
# nothing (timing only: what a step costs).  A "... twice" variant runs one
# step a second time on the same data, so the function holds and its time
# less base's is that step's.  A variant whose patch target is not in the
# source is skipped.
VARIANTS = {
    "base": ([], "bits", None),
    "IEEE division": (
        [("div_unit(S + gto, one_m_safe)", "(S + gto) / one_m_safe")],
        "bits", None),
    "no warp cull": ([("  return m;\n}", "  return (1u << kWarps) - 1;\n}"),
                      (("    return m;\n  }\n", None),
                       "    return (1u << kWarps) - 1;\n  }\n")],
                     "bits", None),
    "no hot-row skip": (
        [("hot |= __any_sync(kFull, lit) ? 1u << jj : 0u;",
          "hot |= 1u << jj;")], "bits", None),
    "3 CTAs per SM": (
        [("constexpr int kWarpsPerSm = 16;", "constexpr int kWarpsPerSm = 12;"),
         *_ONLY_16], "bits", (16,)),
    "staging twice": (
        [(("#pragma unroll\n      for (int h = 0; h < G::kStage; ++h) {",
           "#pragma unroll\n    for (int h = 0; h < G::kStage; ++h) {"),
          "for (int rep = 0; rep < 2; ++rep)\n{old}"),
         (("#pragma unroll\n        for (int h = 0; h < G::kStage; ++h) {",
           None), "for (int rep = 0; rep < 2; ++rep)\n{old}")],
        "bits", None),
    "write loop twice": (
        [("        for (int idx = tid; idx < kSub * (FUSED ? NG + 1 : NG);",
          "        for (int rep = 0; rep < 2; ++rep)\n"
          "        for (int idx = tid; idx < kSub * (FUSED ? NG + 1 : NG);")],
        "bits", None),
    "tile 32: one band-sum buffer (two barriers per sub-block)": (
        [("kSumBufs = TILE == 32 ? 2 : 1", "kSumBufs = 1")], "bits", (32,)),
    "tile 32: 32x2 bands (the forward's)": (
        [("kSquare = TILE == 32;", "kSquare = false;")], "plain", (32,)),
    "tile 32: 32x2 bands and a cluster of 4 CTAs per tile": (
        _CLUSTER32, "plain", (32,)),
    "tile 8: 256-row windows staged": (
        [("kStageRows = TILE == 8 ? kAlign : kChunk",
          "kStageRows = kChunk")], "bits", (8,)),
    "tile 8: 16-row sub-blocks": (
        [("kSub = TILE == 8 ? 8 : 16", "kSub = 16")], "bits", (8,)),
    "CTA clock probe": (_PROBE, "probe", None),
    "no sub-block barriers (timing only)": (
        [("        __syncthreads();\n        const int n = s1 - s0;",
          "        const int n = s1 - s0;"),
         (("          __syncthreads();  // part[] is rewritten by the next "
           "sub-block\n", "        __syncthreads();  // part[] is rewritten "
           "by the next sub-block\n"), "")], None, None),
    "no reduction of full batches (timing only)": (
        [("reduce_rows<NG, 4>(acc, lane);\n            put(3);\n          }"
          " else if (jr[2] >= 0)", "put(3);\n          } else if (jr[2] >= 0)")],
        None, None),
    "no pass A (timing only)": (
        [(("for (unsigned m = live_rows(sm.mask, s0 - r0, s1 - s0, warp, "
           "lane);\n             m;)",
           "for (unsigned m = live_rows(sm.mask, s0, s1 - s0, warp, lane); "
           "m;)"), "for (unsigned m = 0; m;)")], None, None),
}


def build_variants(tmp: Path, sources, variants=VARIANTS,
                   source="tile_raster_bwd"):
    """Compile csrc/<source>.cu with each of ``variants``' text patches (or
    the text in ``sources`` under the variant's name), all nvcc processes
    started together; returns {variant: loaded library}, without the
    variants whose patch target is not in the source."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    src = sources.get("base") or (build.SRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for name, spec in variants.items():
        text = sources.get(name, src)
        # a patch's target may list alternatives (this source's, an earlier
        # one's): the first found is patched, and "{old}" in the new text
        # stands for it; a None alternative makes the patch optional
        patches, missing = [], False
        for old, new in spec[0]:
            alts = old if isinstance(old, tuple) else (old,)
            found = next((o for o in alts if o is not None and o in text),
                         None)
            if found is not None:
                patches.append((found, new.replace("{old}", found)))
            elif None not in alts:
                missing = True
        if missing:
            cs.log(f"[build] {name}: skipped, a patch target is not in the "
                   f"source")
            continue
        for old, new in patches:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: patch target not unique")
            text = text.replace(old, new)
        stem = re.sub(r"\W+", "_", name)
        (tmp / f"{stem}.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp / f"{stem}.so"),
             str(tmp / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem)
    libs = {}
    for name, (proc, stem) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        cs.log(f"[build] {name}: registers {regs}, spill bytes {spills}")
        lib = ctypes.CDLL(str(tmp / f"{stem}.so"))
        lib.gsv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gsv_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def shares(tag, table, starts, nproc, cfg, ntiles=384, sizes=(16, 128),
           square=False):
    """Over a sample of tiles: the shares of blended (row, band) pairs the
    warp cull keeps and that have a lit pixel, and how evenly the bands
    share the kept rows (pass B's work) and the lit rows (pass C's) of
    each ``sizes``-row block (aligned as the kernels' windows): the sum
    over blocks of the mean band's rows over the sum of the busiest
    band's, 1 where every band has the same work.  ``square``: B3's 8x8
    square bands (32x32)."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
        fragments,
        tile_pixel_grid,
    )

    dev = table.device
    bands = cfg.tile_size ** 2 // b1.BAND_PIXELS
    gen = torch.Generator(device="cpu").manual_seed(1)
    ids = torch.randperm(starts.shape[0] - 1, generator=gen)[:ntiles].to(dev)
    blended = cs.rows_blended(starts, nproc)[ids]
    r = torch.arange(int(blended.max()), device=dev)
    live = r[None] < blended[:, None]
    st = starts[:-1].long()[ids][:, None]
    rows = table[:11, torch.where(live, st + r, st)]
    px, py = tile_pixel_grid(cfg, cfg.tiles_y, device=dev)
    kept = b1.warp_cull_plain(rows, live, px[ids], py[ids], square)
    alpha = fragments(rows, live, px[ids], py[ids], cfg)[3]
    band = b1.band_of_pixel(cfg.tile_size, square, dev)
    lit = torch.stack([(alpha[:, :, band == w] > 0).any(-1)
                       for w in range(bands)], -1)
    n = float(live.sum()) * bands
    cs.log(f"[share] {tag}: of {int(n)} blended (row, band) pairs in "
           f"{len(ids)} tiles ({bands} bands) the cull keeps "
           f"{float(kept.sum()) / n:.4f}, {float(lit.sum()) / n:.4f} have a "
           f"lit pixel")
    off = st + r[None] - st // 128 * 128
    for size in sizes:
        sb = torch.where(live, off // size, 0)
        for what, work in (("kept", kept), ("lit", lit)):
            cnt = torch.zeros((len(ids), int(sb.max()) + 1, bands),
                              device=dev)
            cnt.scatter_add_(1, sb[:, :, None].expand(-1, -1, bands),
                             (work & live[:, :, None]).float())
            cs.log(f"[share] {tag}: band balance over {size}-row blocks, "
                   f"{what} rows (sum of mean / sum of max per band) "
                   f"{float(cnt.mean(-1).sum() / cnt.max(-1).values.sum()):.4f}")


def _pose(w, h, z):
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    cam = Camera(h=h, w=w)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, z], np.float32)
    return tf.look_at(eye, [0, 0, 0], [0, -1, 0]), cam.get_project_matrix(), \
        eye


def full_splats(dev, cfg):
    """The 1M-splat bench scene at 1920x1080 projected for ``cfg``
    (chip_smoke.py phases 4, 4b, 5 and 5b)."""
    from gaussiansplattingviewer_tpu_torch.models import random_scene
    from gaussiansplattingviewer_tpu_torch.ops.projection import project

    view, proj, eye = _pose(cs.FULL_W, cs.FULL_H, 9.0)
    scene = random_scene(cs.FULL_SPLATS, sh_degree=3, seed=0, extent=4.0,
                         mean_scale=0.015).pad_to_multiple(1024).to(dev)
    with torch.no_grad():
        return project(scene, view, proj, eye, cfg)


def full_table(dev, tile_size=16):
    """(binned splats, cfg) of the 1M-splat bench scene at 1920x1080 and
    ``tile_size`` (chip_smoke.py phases 4, 5 and 5b)."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.ops import binning

    cfg = RenderConfig(width=cs.FULL_W, height=cs.FULL_H,
                       tile_size=tile_size)
    with torch.no_grad():
        return binning.bin_splats(full_splats(dev, cfg), cfg), cfg


def garden_passes(dev):
    """(ops/fused.py's train forward, cfg) of the 5.8M-splat garden scene
    at its autotuned config (chip_smoke.py phase 8)."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.models import random_scene
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops import fused as fz
    from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
    from gaussiansplattingviewer_tpu_torch.ops.projection import project

    view, proj, eye = _pose(cs.GARDEN_W, cs.GARDEN_H, 11.0)
    scene = random_scene(cs.GARDEN_SPLATS, sh_degree=3, seed=0, extent=6.0,
                         mean_scale=0.012, anisotropy=1.0,
                         opacity_mix=True).pad_to_multiple(1024).to(dev)
    gcfg = autotune(scene, [view], [proj], [eye],
                    RenderConfig(width=cs.GARDEN_W, height=cs.GARDEN_H),
                    probe=True, fused=None)
    with torch.no_grad():
        pres = binning.bin_splats_presort(
            project(scene, view, proj, eye, gcfg), gcfg)
        return fz._forward(gcfg, gcfg.tiles_y, 1, pres.table_src,
                           pres.rows_sorted, pres.starts_full, 0,
                           train=True), gcfg


def b3_inputs(dev, tile_size=16):
    """B3's arguments at the 1M step (its table and the cotangents of
    sum(img^2)) at ``tile_size``."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    bs, cfg = full_table(dev, tile_size)
    with torch.no_grad():
        rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(
            bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        shares(f"1M step tile {tile_size}", bs.table, bs.tile_starts, nproc,
               cfg, square=b3.square_bands(tile_size))
        if b3.square_bands(tile_size):
            shares(f"1M step tile {tile_size}, 32x2 bands", bs.table,
                   bs.tile_starts, nproc, cfg)
    g_rgb, g_trans = cs.image_cotangents(rgb, trans, cfg)
    return (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, 0,
            g_rgb, g_trans, trans, cfg)


def b5_inputs(dev):
    """B5's arguments at the garden step's pass 1."""
    from gaussiansplattingviewer_tpu_torch.ops import fused as fz

    f, gcfg = garden_passes(dev)
    ntile = gcfg.num_tiles
    gg_rgb, gg_trans = cs.image_cotangents(f["rgb"], f["trans"], gcfg)
    budget = fz._grad_budget(gcfg, f["table1"].shape[1], ntile)
    np1, goff1, _, _ = fz._regions(f["pstarts_c"], f["pcounts"],
                                   f["nproc1"], budget, ntile)
    with torch.no_grad():
        shares("garden pass 1", f["table1"], f["pstarts_c"], np1, gcfg)
    return (f["table1"], f["pstarts_c"], f["pcounts"], np1, goff1,
            f["ckpt1"], 0, gg_rgb, gg_trans, f["trans"],
            (gg_rgb * f["rgb2"]).sum(dim=-1), torch.ones_like(f["trans"]),
            budget, gcfg)


def worst_column(got, want):
    return max(float((got[c] - want[c]).abs().max())
               / max(float(want[c].abs().max()), 1e-30) for c in range(9))


def probe_report(tag, g, ms, warps):
    """What the clock probe's rows say: the spread of the CTAs' times, the
    tail after the last CTA started, and the warps resident per SM (of the
    launch's ``warps`` in all, 2 pixels per thread)."""
    ran = g[13] == 1.0
    warps_per_cta = warps / int(ran.sum())
    sm = g[9][ran].view(torch.int32).long()
    t0 = g[10][ran].view(torch.int32).long() & 0xFFFFFFFF
    t1 = g[11][ran].view(torch.int32).long() & 0xFFFFFFFF
    cyc = g[12][ran].view(torch.int32).long()
    first = int(t0.min())
    t0 = (t0 - first) % (1 << 32)  # ns since the first CTA started
    t1 = (t1 - first) % (1 << 32)
    dur = (t1 - t0).double()
    span = float(t1.max())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    q = torch.quantile(dur, torch.tensor([0.5, 0.9, 0.99], device=g.device,
                                          dtype=torch.float64))
    last_start = float(t0.max())
    per_sm = torch.zeros(n_sm, dtype=torch.float64, device=g.device)
    per_sm.index_add_(0, sm, dur)
    resident = per_sm / span  # CTAs resident on each SM, time-averaged
    cs.log(
        f"[probe] {tag}: {int(ran.sum())} CTAs on {int(sm.unique().numel())}"
        f" SMs, span {span / 1e6:.4f} ms (event time {ms:.3f} ms); CTA time "
        f"mean {float(dur.mean()) / 1e3:.2f} us, p50 {float(q[0]) / 1e3:.2f},"
        f" p90 {float(q[1]) / 1e3:.2f}, p99 {float(q[2]) / 1e3:.2f}, max "
        f"{float(dur.max()) / 1e3:.2f} us (cv "
        f"{float(dur.std() / dur.mean()):.3f}; {float(cyc.double().mean()):.0f}"
        f" cycles mean); tail after the last CTA started "
        f"{(span - last_start) / 1e3:.2f} us ({(span - last_start) / span:.4f}"
        f" of the span); resident CTAs per SM mean "
        f"{float(resident.mean()):.3f} (min {float(resident.min()):.3f}, max "
        f"{float(resident.max()):.3f}) -> achieved warps per SM "
        f"{float(resident.mean()) * warps_per_cta:.2f}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Ablation of kernels B3 and B5.")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another tile_raster_bwd.cu as NAME (its "
                         "function is held to the plain version too)")
    ap.add_argument("--base", metavar="PATH",
                    help="patch and time this tile_raster_bwd.cu as base "
                         "(default: the checkout's)")
    ap.add_argument("--tiles", default="8,16,32",
                    help="tile sizes B3 is timed at (comma-separated)")
    ap.add_argument("--no-garden", action="store_true",
                    help="leave out B5 on the garden step")
    args = ap.parse_args(argv)
    tiles = [int(x) for x in args.tiles.split(",")]
    variants = dict(VARIANTS)
    sources = {"base": Path(args.base).read_text()} if args.base else {}
    for item in args.source:
        name, path = item.split("=", 1)
        variants[name] = ([], "plain", None)
        sources[name] = Path(path).read_text()
    if not torch.cuda.is_available():
        print("bwd_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gaussiansplattingviewer_tpu_torch.config import RenderMode
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )

    dev = torch.device("cuda")
    cs.log("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), sources, variants)
        for name in libs:
            build._LIBS["tile_raster_bwd"] = libs[name]
            for ts in tiles:
                if not variants[name][2] or ts in variants[name][2]:
                    occ = b3.kernel_occupancy(RenderMode.SH3, False, ts)
                    cs.log(f"[occupancy] {name} tile {ts} SH3: {occ}")
        b5_args = None if args.no_garden else b5_inputs(dev)
        plain5 = None if b5_args is None \
            else b3.tile_raster_bwd_fused_plain(*b5_args)
        for ts in tiles:
            b3_args = b3_inputs(dev, ts)
            cfg = b3_args[-1]
            plain3 = b3.tile_raster_bwd_plain(*b3_args)
            with_b5 = b5_args is not None and ts == 16
            base = None
            for rnd in range(2):
                for name, (_, held, only) in variants.items():
                    if name not in libs or (only and ts not in only):
                        continue
                    build._LIBS["tile_raster_bwd"] = libs[name]
                    b3.tile_raster_bwd(*b3_args)  # warm-up
                    ms3, g3 = cs.cuda_ms(
                        lambda: b3.tile_raster_bwd(*b3_args), 10)
                    ms5, g5 = None, None
                    if with_b5:
                        b3.tile_raster_bwd_fused(*b5_args)
                        ms5, g5 = cs.cuda_ms(
                            lambda: b3.tile_raster_bwd_fused(*b5_args), 10)
                    if base is None:
                        base = (g3.clone(), g5)
                    note = ""
                    if held:
                        rows = slice(0, 9) if held == "probe" else slice(None)
                        e3 = worst_column(g3, plain3)
                        same = torch.equal(g3[rows], base[0][rows])
                        again = torch.equal(g3[rows], b3.tile_raster_bwd(
                            *b3_args)[rows])
                        e5 = 0.0
                        if with_b5:
                            e5 = worst_column(g5, plain5)
                            same = same and torch.equal(g5, base[1])
                            again = again and torch.equal(
                                g5, b3.tile_raster_bwd_fused(*b5_args))
                        note = (f"; worst column vs plain {e3:.2e}"
                                + (f" / {e5:.2e}" if with_b5 else "")
                                + f", bit-equal to base {same}, to its own "
                                  f"second launch {again}")
                        if not (e3 <= 1e-5 and e5 <= 1e-5 and again
                                and (same or held == "plain")):
                            raise AssertionError(
                                f"{name} changed the function at tile {ts}")
                    cs.log(f"[ablate] tile {ts} round {rnd} {name}: B3 1M "
                           f"step {ms3:.3f} ms"
                           + (f", B5 garden pass 1 {ms5:.3f} ms"
                              if with_b5 else "") + note)
                    if held == "probe":
                        probe_report(f"tile {ts} round {rnd}", g3, ms3,
                                     cfg.num_tiles * ts * ts // 64)
            del b3_args, plain3, base
            torch.cuda.empty_cache()
        build._LIBS.pop("tile_raster_bwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
