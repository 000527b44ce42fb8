#!/usr/bin/env python3
"""Ablation of the blend backward (kernels B3 and B5, one template in
gaussiansplattingviewer_tpu_torch/csrc/tile_raster_bwd.cu) on one CUDA card.

  python3 bwd_ablation.py [--source NAME=PATH.cu ...]

Builds the source as it is ("base") and variants of it, each with one step
of the design switched off by a text patch, plus any other source of the
same C interface named with --source (an earlier version of the file
that takes the tile size argument, say),
and times each with CUDA events
on two real inputs: B3 on the 1M-splat training step's table and
cotangents (chip_smoke.py phase 5) and B5 on the garden step's pass-1
table (phase 8).  Variants that keep the function are held bit-equal to
base and within 1e-5 of max|plain column| of the plain version; the
timing-only variants (results discarded) show what a step costs.  Also
prints, over a sample of tiles, the shares of blended (row, band) pairs
the warp cull keeps and that have a lit pixel, and how evenly the 4 bands
share a sub-block's rows.  Needs the card and nvcc; imports no JAX.
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

# variants whose geometry holds at 16x16 only (launch bounds of 0 CTAs at
# 32x32) leave out B3's other tile sizes
_ONLY_16 = [
    ("    if (tile == 8) return by_mode<8, FUSED>(mode, f);\n", ""),
    ("    if (tile == 32) return by_mode<32, FUSED>(mode, f);\n", "")]
# name: (text patches, what is held: "bits" equal to base and within the
# plain version's tolerance, "plain" that tolerance only, None nothing)
VARIANTS = {
    "base": ([], "bits"),
    "IEEE division": (
        [("div_unit(S + gto, one_m_safe)", "(S + gto) / one_m_safe")],
        "bits"),
    "no warp cull": ([("  return m;\n}", "  return (1u << kWarps) - 1;\n}")],
                     "bits"),
    "no hot-row skip": (
        [("hot |= __any_sync(kFull, lit) ? 1u << jj : 0u;",
          "hot |= 1u << jj;")], "bits"),
    "3 CTAs per SM": (
        [("constexpr int kWarpsPerSm = 16;", "constexpr int kWarpsPerSm = 12;"),
         *_ONLY_16], "bits"),
    "no reduction of full batches (timing only)": (
        [("reduce_rows<NG, 4>(acc, lane);\n            put(3);\n          }"
          " else if (jr[2] >= 0)", "put(3);\n          } else if (jr[2] >= 0)")],
        None),
    "no pass A (timing only)": (
        [("for (unsigned m = live_rows(sm.mask, s0, s1 - s0, warp, lane); m;)",
          "for (unsigned m = 0; m;)")], None),
}


def build_variants(tmp: Path, sources, variants=VARIANTS,
                   source="tile_raster_bwd"):
    """Compile csrc/<source>.cu with each of ``variants``' text patches (or
    the text in ``sources`` under the variant's name), all nvcc processes
    started together; returns {variant: loaded library}."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    src = (build.SRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for name, (patches, _) in variants.items():
        text = sources.get(name, src)
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


def shares(tag, table, starts, nproc, cfg, ntiles=384, sizes=(16, 128)):
    """Over a sample of tiles: the shares of blended (row, band) pairs the
    warp cull keeps and that have a lit pixel, and how evenly the bands
    share the lit rows of each ``sizes``-row block (aligned as the
    kernels' windows)."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
        fragments,
        tile_pixel_grid,
    )

    dev = table.device
    gen = torch.Generator(device="cpu").manual_seed(1)
    ids = torch.randperm(starts.shape[0] - 1, generator=gen)[:ntiles].to(dev)
    blended = cs.rows_blended(starts, nproc)[ids]
    r = torch.arange(int(blended.max()), device=dev)
    live = r[None] < blended[:, None]
    st = starts[:-1].long()[ids][:, None]
    rows = table[:11, torch.where(live, st + r, st)]
    px, py = tile_pixel_grid(cfg, cfg.tiles_y, device=dev)
    kept = b1.warp_cull_plain(rows, live, px[ids], py[ids])
    alpha = fragments(rows, live, px[ids], py[ids], cfg)[3]
    lit = (alpha > 0).reshape(*alpha.shape[:2], b1.BANDS, -1).any(-1)
    n = float(live.sum()) * b1.BANDS
    cs.log(f"[share] {tag}: of {int(n)} blended (row, band) pairs in "
           f"{ntiles} tiles the cull keeps {float(kept.sum()) / n:.4f}, "
           f"{float(lit.sum()) / n:.4f} have a lit pixel")
    off = st + r[None] - st // 128 * 128
    for size in sizes:
        sb = torch.where(live, off // size, 0)
        cnt = torch.zeros((len(ids), int(sb.max()) + 1, b1.BANDS),
                          device=dev)
        cnt.scatter_add_(1, sb[:, :, None].expand(-1, -1, b1.BANDS),
                         (lit & live[:, :, None]).float())
        cs.log(f"[share] {tag}: band balance over {size}-row sub-blocks "
               f"(sum of mean / sum of max lit rows per band) "
               f"{float(cnt.mean(-1).sum() / cnt.max(-1).values.sum()):.4f}")


def _pose(w, h, z):
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    cam = Camera(h=h, w=w)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, z], np.float32)
    return tf.look_at(eye, [0, 0, 0], [0, -1, 0]), cam.get_project_matrix(), \
        eye


def full_table(dev):
    """(binned splats, cfg) of the 1M-splat bench scene at 1920x1080
    (chip_smoke.py phases 4 and 5)."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.models import random_scene
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.projection import project

    cfg = RenderConfig(width=cs.FULL_W, height=cs.FULL_H)
    view, proj, eye = _pose(cs.FULL_W, cs.FULL_H, 9.0)
    scene = random_scene(cs.FULL_SPLATS, sh_degree=3, seed=0, extent=4.0,
                         mean_scale=0.015).pad_to_multiple(1024).to(dev)
    with torch.no_grad():
        return binning.bin_splats(project(scene, view, proj, eye, cfg),
                                  cfg), cfg


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


def inputs(dev):
    """B3's arguments at the 1M step and B5's at the garden step's pass 1."""
    from gaussiansplattingviewer_tpu_torch.ops import fused as fz
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    bs, cfg = full_table(dev)
    with torch.no_grad():
        rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(
            bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        shares("1M step", bs.table, bs.tile_starts, nproc, cfg)
    g_rgb, g_trans = cs.image_cotangents(rgb, trans, cfg)
    b3_args = (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, 0,
               g_rgb, g_trans, trans, cfg)

    f, gcfg = garden_passes(dev)
    ntile = gcfg.num_tiles
    gg_rgb, gg_trans = cs.image_cotangents(f["rgb"], f["trans"], gcfg)
    budget = fz._grad_budget(gcfg, f["table1"].shape[1], ntile)
    np1, goff1, _, _ = fz._regions(f["pstarts_c"], f["pcounts"],
                                   f["nproc1"], budget, ntile)
    with torch.no_grad():
        shares("garden pass 1", f["table1"], f["pstarts_c"], np1, gcfg)
    b5_args = (f["table1"], f["pstarts_c"], f["pcounts"], np1, goff1,
               f["ckpt1"], 0, gg_rgb, gg_trans, f["trans"],
               (gg_rgb * f["rgb2"]).sum(dim=-1), torch.ones_like(f["trans"]),
               budget, gcfg)
    return b3_args, b5_args


def worst_column(got, want):
    return max(float((got[c] - want[c]).abs().max())
               / max(float(want[c].abs().max()), 1e-30) for c in range(9))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Ablation of kernels B3 and B5.")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time another tile_raster_bwd.cu as NAME (its "
                         "function is held to the plain version too)")
    args = ap.parse_args(argv)
    sources = {}
    for item in args.source:
        name, path = item.split("=", 1)
        VARIANTS[name] = ([], "plain")
        sources[name] = Path(path).read_text()
    if not torch.cuda.is_available():
        print("bwd_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
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
        libs = build_variants(Path(tmp), sources)
        b3_args, b5_args = inputs(dev)
        plain3 = b3.tile_raster_bwd_plain(*b3_args)
        plain5 = b3.tile_raster_bwd_fused_plain(*b5_args)
        base = None
        for rnd in range(2):
            for name, (_, held) in VARIANTS.items():
                build._LIBS["tile_raster_bwd"] = libs[name]
                b3.tile_raster_bwd(*b3_args)  # warm-up
                ms3, g3 = cs.cuda_ms(lambda: b3.tile_raster_bwd(*b3_args), 10)
                b3.tile_raster_bwd_fused(*b5_args)
                ms5, g5 = cs.cuda_ms(
                    lambda: b3.tile_raster_bwd_fused(*b5_args), 10)
                if base is None:
                    base = (g3.clone(), g5.clone())
                note = ""
                if held:
                    e3, e5 = worst_column(g3, plain3), worst_column(g5, plain5)
                    same = torch.equal(g3, base[0]) and torch.equal(g5,
                                                                    base[1])
                    note = (f"; worst column vs plain {e3:.2e} / {e5:.2e}, "
                            f"bit-equal to base {same}")
                    if not (e3 <= 1e-5 and e5 <= 1e-5
                            and (same or held == "plain")):
                        raise AssertionError(f"{name} changed the function")
                cs.log(f"[ablate] round {rnd} {name}: B3 1M step "
                       f"{ms3:.3f} ms, B5 garden pass 1 {ms5:.3f} ms{note}")
        build._LIBS.pop("tile_raster_bwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
