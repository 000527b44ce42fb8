#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaussiansplattingviewer_tpu_torch)
on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from csrc/ (one nvcc per source, started
     together), print nvcc's -Xptxas -v report and, per kernel (B1, B2,
     B4 in both variants, B3, B5; B1, B2, B4 inference and B3 also at
     tiles 8 and 32) and mode, its registers, spills, shared memory per CTA
     and CTAs per SM as built;
  3. every kernel (B1 inference forward, B2 train forward, B3 blend
     backward, B4 seeded forward in both variants, B5 compact backward)
     against its plain PyTorch version on the 10k-splat golden scene at
     1160x522: all 7 modes, an opaque early-stop scene and an interleaved
     shard (B4/B5 on the fused path's own pass-1 and pass-2 inputs,
     prefix_rows 32); the rendered images against the stored goldens
     (tests/goldens);
 3b. tile sizes 8 and 32, which the classic kernels also take: B1, B2,
     B3 (also against its own second launch, bit for bit) and B4
     (train=False, on the fused serving path's pass-2 inputs) against
     their plain versions on the golden scene in all 7 modes, the opaque
     copy and the shard; CUDA tensors at tile 8 through the fused training
     kernels (B4 train, B5), and at tile 24 through every kernel, raise and
     launch nothing;
  4. the serving path at full size: the 1M-splat SH-3 bench scene at
     1920x1080 through render() under no_grad, with CUDA-event stage times
     and B1 held against its plain version on the same table;
 4b. the same frame at tile sizes 8 and 32: 3 frames each (B1 once per
     frame) and B1 alone against its plain version with its bound; at 8,
     16 and 32, 2 frames on the fused serving path (B1 and B4 once each)
     and B4 alone;
  5. the training step at full size (the JAX bench.py default step: loss
     sum(img^2), SGD at lr 1e-12): CUDA-event stage times inside real
     steps, B2 and B3 timed alone and held against their plain versions on
     a step's own table (B3 also against its own second launch, bit for
     bit), two backwards' gradients bit for bit, the device's busy share
     (torch.profiler), 5 timed steps through render() + backward(), their
     launch counts and gradients;
 5b. the same training step at tile sizes 8 and 32 (classic path, as the
     JAX package's XLA executor trains there), without the profiler;
  6. the trainer through its CLI (apps.train.main, 3 self-distill steps at
     1920x1080 from the 1M scene written as a PLY scene dir);
  7. the serve app on 127.0.0.1 answering /info and three /render requests;
  8. the sharded cell (parallel/sharded_render.py) on the 1M scene at
     1920x1080: the band programs of 4 tile-row shards run by index
     (contiguous, interleaved, pre-culled bands), each assembled image
     against render() and B1 launched once per band, each band's kept
     splats, drops and B1 time beside the unsharded B1 (B1 of band 1 also
     against its plain version); the gradient of sum(img^2) through the 4
     contiguous bands (B2 and B3 4 each) against the single render's, f32
     fold, and the single render's classic gradient twice, bit for bit;
     3 steps of make_sharded_train_step in a one-rank NCCL group
     (replicated, then shard_splats with exchange), the loss falling;
 8b. the apps on phase 6's PLY at 1920x1080, B1 once per frame: the
     native PLY load bit-equal to numpy's (or which fallback ran), the
     native PNG encoders timed against PIL's, the viewer (an 8-frame
     orbit, a DEPTH frame, its frame in
     utils.profiling.FrameTimer and a 3-frame torch.profiler trace written
     to chiprun_out/), dataset_gen over 4 COLMAP poses (3 frames each; a
     second run renders none; the disparity PNG equal to a direct DEPTH
     render x 65535 to 1 LSB), PSNR / SSIM and the point cloud of its
     triplets, render_all over two scene dirs (1M and golden, 2 poses
     each), serve --gs-model answering one /render, and
     eval.compare_backends kernel against oracle on the golden scene;
  9. the garden cell, the JAX bench.py garden workload: 5.8M splats, SH-3,
     1920x1080, config from autotune(probe=True, fused=None) (forced fused
     if the tuner declines).  5 fused training steps (sum(img^2), SGD)
     with CUDA-event stage times and launch counts (B2 1, B4 1, B5 2 per
     step), 5 classic steps on the same scene and pose, fused (K = 0 and
     the tuned K) against classic gradients with the f32 fold and classic
     against itself bit for bit, the classic fold (a segment sum per
     splat) timed against one index_add_ and the fused f64 fold against a
     sorted variant, 3 served frames (B1 1, B4 1 each), and B4/B5 timed
     alone against their plain versions on a step's own inputs (B5 also
     against its own second launch, bit for bit);
 9b. the tile executor (ops/blend.py, plain PyTorch, JAX's XLA executor):
     the parity check (eval.gradcheck, scripts/tpu_gradcheck.py's port)
     of the kernel route against it on the same card, its toy case (B1,
     B2, B3) and its 500k-splat 1920x1080 fused case (B2, B4, B5), within
     tpu_gradcheck.py's thresholds; the 1M scene at 1920x1080 served once
     and trained one step through backend="tile" (no kernel launches, the
     frame within 5e-4 of the kernel route's), its frame and step ms read
     beside the card's name and power limit;
 10. the JAX repository's measurement entry points as the port's modules,
     each run as a subprocess from the repository's root: ``python -m
     gaussiansplattingviewer_tpu_torch.bench`` with its defaults (the 1M
     training step, the forward, the garden step, the parity check): rc 0,
     bench.py's keys and the port's four in its last line, parity_pass
     true, and per profiled step B2 and B3 once (1M, classic), B1 once
     (forward), B2 and B4 once and B5 twice (garden);
     ``eval.ply_roundtrip`` at 5.8M splats passing every gate;
     ``eval.scaling`` with N shard times per row, efficiencies in (0,
     1.05], the bands of every row that dropped no splat within the early
     stop of render() and no bandwidth constant; each module's seconds
     beside the card;
 11. a JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Each kernel's bound_ms counts the fragments this run's data needs: the
pixels inside each blended row's rect (fragments_needed).

Exits non-zero, printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet), used for bound_ms
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 operations per (pixel, row) fragment of the forward blend (B1, B2):
# 2 offsets, 9 for power, 4 for the rect test, exp, opacity product,
# clamp, 2 threshold tests, select, weight, 6 for the colour update, 2 for T
FLOPS_PER_FRAGMENT = 30
# ... and of the blend backward (B3), counted from csrc/tile_raster_bwd.cu
# as the function needs them once: the forward's 21 up to alpha plus the
# unclamped test, 2 for t_i, w, 5 for g.c, u, the suffix add, 2 for
# max(1 - alpha, .), S + g_T T, the divide, t g.c, the subtraction, the
# alpha > 0 select, 3 for d_power, 2 for the opacity term, 4 + 4 + 3 + 3
# + 3 for cx, cy, A, B, C, 3 for rgb, and 9 adds of the pixel reduction
FLOPS_PER_FRAGMENT_B3 = 73
BLEND_ATTR_BYTES = 11 * 4  # table rows read per splat row (cx .. ry)
# B4 does B1/B2's fragment work, B5 B3's (csrc/*.cu: template variants)

GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "goldens"
GOLDEN_MODES = ("SH1", "SH2", "SH3", "DEPTH", "BILLBOARD", "FLAT_BALL",
                "GAUSSIAN_BALL")
FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
DEVICE = "cuda"
# the full cell: the JAX bench.py default scene and resolution
FULL_SPLATS, FULL_W, FULL_H = 1_000_000, 1920, 1080
GOLDEN_W, GOLDEN_H, GOLDEN_SPLATS = 1160, 522, 10_000
# the garden cell: the JAX bench.py garden scene (bench.py:84-93)
GARDEN_SPLATS, GARDEN_W, GARDEN_H = 5_800_000, 1920, 1080
# B4/B5 checks on the golden scene: its tile lists hold at most ~100 rows,
# so the prefix is 32 rows (256 would leave the residual pass empty)
GOLDEN_FUSED = dict(fused_grad=True, prefix_rows=32,
                    residual_budget_rows=1 << 20)
SERVE_W, SERVE_H = 960, 540
# the inference forward (B1, B4 train=False) also takes these tile sizes
TILE_SIZES = (8, 32)
# fused serving prefixes: the golden checks' 32 rows at tile 16 and the
# 1M frame's 256, scaled by the tile's pixels
GOLDEN_PREFIX = {8: 8, 16: 32, 32: 128}
FULL_PREFIX = {8: 64, 16: 256, 32: 1024}
FUSED_RESIDUAL_ROWS = 1 << 23
# compare_backends, kernel against oracle: max_abs within 1e-4 on the JAX
# flip harness's scene (tests/test_golden.py: the kernel stops a tile at
# T < 1e-4 where the oracle blends every splat).  On the golden scene the
# tile path orders splats by the top 20 bits of their depth (binning's
# key at 2,409 tiles), the oracle by exact depth, so near-equal depths of
# overlapping splats blend in another order in a few pixels, as in the JAX
# package: gated on the mean and the PSNR there
COMPARE_TOL = 1e-4
GOLDEN_COMPARE = {"mean_abs": 1e-4, "psnr": 50.0}
SGD_LR = 1e-12  # bench.py's: keeps the scene statistically unchanged
TRAIN_STEPS = 5


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def host_ms(fn):
    """Milliseconds of one call of ``fn`` on the host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


class Checks:
    """Every kernel-vs-plain comparison of the run, and each kernel's
    largest absolute difference."""

    def __init__(self):
        self.err = {k: 0.0 for k in ("B1", "B2", "B3", "B4", "B5")}

    def _record(self, kernel, tag, err, tol):
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        log(f"[check] {tag}: max|diff| {err:.3e} (tol {tol:.1e})")
        if not err <= tol:
            raise AssertionError(f"{tag}: kernel disagrees with plain")

    def close(self, kernel, tag, got, want):
        """Within 1e-5 * max(1, |plain|): the kernels compile with
        -fmad=false, so only the order of sums differs."""
        err = float((got - want).abs().max()) if got.numel() else 0.0
        tol = 1e-5 * max(1.0, float(want.abs().max()) if want.numel()
                         else 0.0)
        self._record(kernel, tag, err, tol)

    def equal(self, kernel, tag, got, want):
        """Bit for bit: integers and sequential products."""
        same = torch.equal(got, want)
        err = 0.0 if same else float(
            (got.double() - want.double()).abs().max())
        self._record(kernel, tag, err, 0.0)

    def columns(self, kernel, tag, got, want):
        """Per table column within 1e-5 * max|plain column|: B3 (B5) and
        its plain version share t_i and alpha bit for bit, and differ only
        in the order of each row's sum over 256 pixels and of the suffix.
        B5's id row (15) must be equal."""
        worst, err = 0.0, 0.0
        if kernel == "B5" and not torch.equal(got[15], want[15]):
            raise AssertionError(f"{tag}: B5 id row differs from plain")
        for c in range(got.shape[0]):
            e = float((got[c] - want[c]).abs().max())
            scale = float(want[c].abs().max())
            err = max(err, e)
            if e > 0:
                worst = max(worst, e / scale if scale > 0 else float("inf"))
        log(f"[check] {tag}: max|diff| {err:.3e}, worst column "
            f"|diff|/max|plain| {worst:.3e} (tol 1.0e-05)")
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not worst <= 1e-5:
            raise AssertionError(f"{tag}: kernel disagrees with plain")


def seeded_cotangents(trans, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen)
    g_trans = torch.randn(tuple(trans.shape), generator=gen)
    return g_rgb.to(trans.device), g_trans.to(trans.device)


def kernels_vs_plain(chk, tag, bs, cfg, row_offset=0, band=()):
    """B1, B2 and B3 against their plain versions on one binned table, at
    cfg.tile_size; returns B2's nproc."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    sfx = "" if cfg.tile_size == 16 else f" t{cfg.tile_size}"
    args = (bs.table, bs.tile_starts, bs.tile_counts, row_offset, cfg, *band)
    rgb, trans = b1.tile_raster_fwd(*args)
    torch.cuda.synchronize()
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    chk.close(f"B1{sfx}", f"{tag} B1 rgb", rgb, prgb)
    chk.close(f"B1{sfx}", f"{tag} B1 T", trans, ptrans)

    rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    torch.cuda.synchronize()
    prgb, ptrans, pckpt, pnproc = b1.tile_raster_fwd_train_plain(*args)
    chk.close(f"B2{sfx}", f"{tag} B2 rgb", rgb, prgb)
    chk.close(f"B2{sfx}", f"{tag} B2 T", trans, ptrans)
    chk.equal(f"B2{sfx}", f"{tag} B2 nproc", nproc, pnproc)
    chk.equal(f"B2{sfx}", f"{tag} B2 ckpt", ckpt, pckpt)

    g_rgb, g_trans = seeded_cotangents(trans, seed=7)
    bwd = (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, row_offset,
           g_rgb, g_trans, trans, cfg, *band)
    g = b3.tile_raster_bwd(*bwd)
    torch.cuda.synchronize()
    chk.columns(f"B3{sfx}", f"{tag} B3 g_table", g,
                b3.tile_raster_bwd_plain(*bwd))
    chk.equal(f"B3{sfx}", f"{tag} B3 repeat", g, b3.tile_raster_bwd(*bwd))
    if not float(g.abs().max()) > 0:
        raise AssertionError(f"{tag}: B3 gave a zero gradient")
    return nproc


def fused_vs_plain(chk, tag, splats, cfg, row_offset=0, local_rows=None,
                   row_stride=1):
    """B4 (both variants) and B5 (both passes) against their plain
    versions on the fused path's own inputs: the pass-1 and pass-2 tables
    of ops/fused.py's forward for these splats, cotangents from a seed.
    Returns the rows pass 2 blended."""
    from gaussiansplattingviewer_tpu_torch.ops import binning, fused
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    if local_rows is None:
        local_rows = cfg.tiles_y
    pres = binning.bin_splats_presort(splats, cfg, row_offset, local_rows,
                                      row_stride)
    f = fused._forward(cfg, local_rows, row_stride, pres.table_src,
                       pres.rows_sorted, pres.starts_full, row_offset,
                       train=True)
    band = (row_offset, cfg, local_rows, row_stride)
    seeded = (f["table2"], f["rstarts_c"], f["rcounts"], f["trans1"], *band)
    for train in (False, True):
        out = b1.tile_raster_fwd_seeded(*seeded, train=train)
        torch.cuda.synchronize()
        plain = b1.tile_raster_fwd_seeded_plain(*seeded, train=train)
        v = "train" if train else "inference"
        chk.close("B4", f"{tag} B4 {v} rgb", out[0], plain[0])
        for name, got, want in zip(("T", "ckpt", "nproc"), out[1:],
                                   plain[1:]):
            chk.equal("B4", f"{tag} B4 {v} {name}", got, want)
    rows2 = int(rows_blended(f["rstarts_c"], f["nproc2"]).sum())

    num_tiles = local_rows * cfg.tiles_x
    g_rgb, g_trans = seeded_cotangents(f["trans"], seed=9)
    np2, goff2, need2, _ = fused._regions(f["rstarts_c"], f["rcounts"],
                                          f["nproc2"], 1 << 40, num_tiles)
    np1, goff1, need1, _ = fused._regions(f["pstarts_c"], f["pcounts"],
                                          f["nproc1"], 1 << 40, num_tiles)
    suffix1 = (g_rgb * f["rgb2"]).sum(dim=-1)
    for name, args in (
            ("pass 2", (f["table2"], f["rstarts_c"], f["rcounts"], np2,
                        goff2, f["ckpt2"], row_offset, g_rgb, g_trans,
                        f["trans"], torch.zeros_like(f["trans"]),
                        f["trans1"], int(need2) + 256, cfg, local_rows,
                        row_stride)),
            ("pass 1", (f["table1"], f["pstarts_c"], f["pcounts"], np1,
                        goff1, f["ckpt1"], row_offset, g_rgb, g_trans,
                        f["trans"], suffix1, torch.ones_like(f["trans"]),
                        int(need1) + 256, cfg, local_rows, row_stride))):
        g = b3.tile_raster_bwd_fused(*args)
        torch.cuda.synchronize()
        chk.columns("B5", f"{tag} B5 {name}", g,
                    b3.tile_raster_bwd_fused_plain(*args))
        if name == "pass 1" and not float(g[:9].abs().max()) > 0:
            raise AssertionError(f"{tag}: B5 {name} gave a zero gradient")
    return rows2


def rows_blended(tile_starts, nproc):
    """Rows each tile blended before its early stop, from the windows it
    processed (B2's count; B3 walks the same rows)."""
    from gaussiansplattingviewer_tpu_torch.ops.binning import (
        KERNEL_CHUNK,
        SEGMENT_ALIGN,
    )

    s = tile_starts.to(torch.int64)
    base = s[:-1] // SEGMENT_ALIGN * SEGMENT_ALIGN
    return (torch.minimum(s[1:], base + nproc.to(torch.int64) * KERNEL_CHUNK)
            - s[:-1]).clamp(min=0)


def fragments_needed(table, tile_starts, tile_counts, nproc, cfg,
                     row_offset=0, local_rows=None, row_stride=1):
    """The (pixel, row) fragments a blend needs on this data, for bound_ms:
    for every row a tile blended before its early stop, the tile's pixels
    inside the row's rect, |px - cx| <= rx and |py - cy| <= ry (the
    kernels' own test: every other fragment has alpha 0 and no gradient).
    Returns (rows, fragments in the rects, fragments of the 64-pixel warp
    bands the kernels' cull keeps: rows of the tile, or at 32x32 8x8
    squares, ``square_bands``), the last for the log only."""
    from gaussiansplattingviewer_tpu_torch.ops import binning as b
    from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
        SQUARE,
        band_rows,
        square_bands,
        tile_pixel_grid,
    )

    ts, dev = cfg.tile_size, table.device
    if local_rows is None:
        local_rows = cfg.tiles_y
    px, py = tile_pixel_grid(cfg, local_rows, row_offset, row_stride,
                             device=dev)
    xs, ys = px[:, :ts], py[:, ::ts]  # each tile's column / row centres
    s = tile_starts[:-1].to(torch.int64)
    base = s // b.SEGMENT_ALIGN * b.SEGMENT_ALIGN
    n = torch.minimum(tile_counts.to(torch.int64),
                      base + nproc.to(torch.int64) * b.KERNEL_CHUNK - s
                      ).clamp(min=0)
    total = int(n.sum())
    tile = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    first = torch.repeat_interleave(s - (torch.cumsum(n, 0) - n), n)
    rect = band = 0
    br, square = band_rows(ts), square_bands(ts)
    for i in range(0, total, 1 << 22):
        t = tile[i:i + (1 << 22)]
        c = first[i:i + (1 << 22)] + torch.arange(i, i + len(t), device=dev)
        hx = (xs[t] - table[b.COL_CX, c][:, None]).abs() \
            <= table[b.COL_RX, c][:, None]
        hy = (ys[t] - table[b.COL_CY, c][:, None]).abs() \
            <= table[b.COL_RY, c][:, None]
        nx = hx.sum(1)
        rect += int((nx * hy.sum(1)).sum())
        if square:
            gx = hx.reshape(len(t), -1, SQUARE).any(2).sum(1)
            gy = hy.reshape(len(t), -1, SQUARE).any(2).sum(1)
            band += int((gx * gy).sum()) * SQUARE * SQUARE
        else:
            band += int((hy.reshape(len(t), -1, br).any(2).sum(1)
                         * (nx > 0)).sum()) * br * ts
    return total, rect, band


def needed(tag, table, tile_starts, tile_counts, nproc, cfg, **band):
    """fragments_needed, logged beside the whole-tile count; returns
    (rows blended, fragments in their rects)."""
    rows, rect, kept = fragments_needed(table, tile_starts, tile_counts,
                                        nproc, cfg, **band)
    whole = rows * cfg.tile_size ** 2
    log(f"[bound] {tag}: {rows} rows blended; fragments in their rects "
        f"{rect} ({rect / max(whole, 1):.4f} of their tiles' {whole}), in "
        f"the warp bands the cull keeps {kept} ({kept / max(whole, 1):.4f})")
    return rows, rect


def sgd_step(sc, params, view, proj, eye, cfg, lr=SGD_LR,
             backend="kernel"):
    """One bench.py training step through render_with_aux: loss
    sum(img^2), backward, SGD.  Returns (loss, aux)."""
    from gaussiansplattingviewer_tpu_torch.ops.render import render_with_aux

    for p in params:
        p.grad = None
    img, aux = render_with_aux(sc, view, proj, eye, cfg, backend=backend)
    loss = (img * img).sum()
    loss.backward()
    with torch.no_grad():
        for p in params:
            p.sub_(p.grad, alpha=lr)
    return loss, aux


CLASSIC_STAGES = ("project", "bin", "B2", "image+loss", "B3", "fold",
                  "projection backward", "update")
FUSED_STAGES = ("project", "presort", "pass-1 gather + B2",
                "pass-2 gather + B4", "image+loss", "image bwd", "B5 x2",
                "fold", "projection backward", "update")


def classic_staged_step(sc, params, view, proj, eye, cfg):
    """A classic training step with CUDA events between the forward
    stages and, from autograd hooks, when the table's gradient (after B3)
    and the packed rows' gradient (after the fold) are ready.  Returns the
    CLASSIC_STAGES times in ms."""
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import (
        _tiles_to_image,
    )

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    for p in params:
        p.grad = None
    ev[0].record()
    splats = project(sc, view, proj, eye, cfg)
    ev[1].record()
    bs = binning.bin_splats(splats, cfg)
    ev[2].record()
    rgb, trans = blend_tiles(cfg, cfg.tiles_y, 1, bs.table, bs.tile_starts,
                             bs.tile_counts, 0)
    ev[3].record()
    img, t_img = _tiles_to_image(rgb, trans, cfg)
    img = img + cfg.background * t_img[..., None]
    loss = (img * img).sum()
    ev[4].record()
    bs.table.register_hook(lambda g: ev[5].record())
    packed_node = bs.table.grad_fn.next_functions[0][0]
    packed_node.register_prehook(lambda g: ev[6].record())
    loss.backward()
    ev[7].record()
    with torch.no_grad():
        for p in params:
            p.sub_(p.grad, alpha=SGD_LR)
    ev[8].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(8)]


def fused_staged_step(sc, params, view, proj, eye, cfg):
    """A fused training step with CUDA events between its stages: the
    kernel wrappers and the fold that ops/fused.py calls are wrapped for
    the step to record an event after B2, after B4, before the first and
    after the last B5, and after the fold.  Returns the FUSED_STAGES times
    in ms."""
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops import fused as fz
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import (
        _tiles_to_image,
    )

    ev = {}

    def mark(key):
        ev[key] = torch.cuda.Event(enable_timing=True)
        ev[key].record()

    def wrap(name, before=None, after=None):
        orig = getattr(fz, name)

        def run(*a, **k):
            if before and before not in ev:
                mark(before)
            out = orig(*a, **k)
            mark(after)
            return out
        return orig, run

    wrapped = {"tile_raster_fwd_train": wrap("tile_raster_fwd_train",
                                             after="B2"),
               "tile_raster_fwd_seeded": wrap("tile_raster_fwd_seeded",
                                              after="B4"),
               "tile_raster_bwd_fused": wrap("tile_raster_bwd_fused",
                                             before="B5 start",
                                             after="B5 end"),
               "fold_rows_by_id": wrap("fold_rows_by_id", after="fold")}
    for p in params:
        p.grad = None
    try:
        for name, (_, run) in wrapped.items():
            setattr(fz, name, run)
        mark("start")
        splats = project(sc, view, proj, eye, cfg)
        mark("project")
        pres = binning.bin_splats_presort(splats, cfg)
        mark("presort")
        rgb, trans, _ = fz.blend_fused(cfg, cfg.tiles_y, 1, pres.table_src,
                                       pres.rows_sorted, pres.starts_full, 0)
        img, t_img = _tiles_to_image(rgb, trans, cfg)
        img = img + cfg.background * t_img[..., None]
        loss = (img * img).sum()
        mark("loss")
        loss.backward()
        mark("backward")
    finally:
        for name, (orig, _) in wrapped.items():
            setattr(fz, name, orig)
    with torch.no_grad():
        for p in params:
            p.sub_(p.grad, alpha=SGD_LR)
    mark("update")
    torch.cuda.synchronize()
    order = ("start", "project", "presort", "B2", "B4", "loss", "B5 start",
             "B5 end", "fold", "backward", "update")
    return [ev[a].elapsed_time(ev[b]) for a, b in zip(order, order[1:])]


def staged_means(fn, names, reps=3):
    staged = np.array([fn() for _ in range(reps)])
    return dict(zip(names, staged.mean(axis=0).tolist())), \
        float(staged.sum(axis=1).mean())


def image_cotangents(rgb, trans, cfg):
    """The cotangents a training step's backward hands the blend:
    d sum(img^2) / d (rgb tiles, trans tiles)."""
    from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import (
        _tiles_to_image,
    )

    rgb_l = rgb.detach().requires_grad_(True)
    trans_l = trans.detach().requires_grad_(True)
    img, t_img = _tiles_to_image(rgb_l, trans_l, cfg)
    img = img + cfg.background * t_img[..., None]
    g_rgb, g_trans = torch.autograd.grad((img * img).sum(), (rgb_l, trans_l))
    return g_rgb.contiguous(), g_trans.contiguous()


def grads_of(params):
    return [p.grad.detach().clone() for p in params]


def trained_at_tile(chk, zero_counts, counts, no_launch, scene, view, proj,
                    eye, cfg, smi, profile=False):
    """The 1M training step (bench.py's: sum(img^2), SGD) at
    cfg.tile_size on the classic path: CUDA-event stage times inside real
    steps, B2 and B3 alone on a step's own table and cotangents against
    their plain versions (B3 also against its own second launch, bit for
    bit), their bounds from the fragments the step needs, the gradient of
    two backwards on the same parameters bit for bit, with ``profile`` the
    device's busy share (torch.profiler), then TRAIN_STEPS timed steps
    through render() + backward() with their launch counts (B2 and B3
    once per step) and gradients.  Returns its numbers."""
    from gaussiansplattingviewer_tpu_torch.models import GaussianData
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import render

    ts = cfg.tile_size
    sfx = "" if ts == 16 else f" t{ts}"
    tag = f"[train{sfx}]"
    sc = GaussianData(*(getattr(scene, f).detach().clone()
                        .requires_grad_(True) for f in FIELDS))
    params = [getattr(sc, f) for f in FIELDS]
    out = {}

    def train_step():
        return sgd_step(sc, params, view, proj, eye, cfg)[0]

    for _ in range(2):  # warm-up
        train_step()
    torch.cuda.synchronize()

    # stage times inside real steps (see classic_staged_step)
    stage_ms, stage_sum = staged_means(
        lambda: classic_staged_step(sc, params, view, proj, eye, cfg),
        CLASSIC_STAGES)
    log(f"{tag} stages in a step (CUDA events, mean of 3): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {stage_sum:.3f} ms")

    # the kernels alone on one step's own table and cotangents
    splats = project(sc, view, proj, eye, cfg)
    bs = binning.bin_splats(splats, cfg)
    targs = (bs.table.detach(), bs.tile_starts, bs.tile_counts, 0, cfg)
    with torch.no_grad():
        b1.tile_raster_fwd_train(*targs)  # warm-up
        out["ms_b2"], (rgb, trans, ckpt, nproc) = cuda_ms(
            lambda: b1.tile_raster_fwd_train(*targs), 10)
    g_rgb, g_trans = image_cotangents(rgb, trans, cfg)
    bwd = (targs[0], bs.tile_starts, bs.tile_counts, nproc, ckpt, 0,
           g_rgb, g_trans, trans, cfg)
    b3.tile_raster_bwd(*bwd)  # warm-up
    out["ms_b3"], g_table = cuda_ms(lambda: b3.tile_raster_bwd(*bwd), 5)
    chk.equal(f"B3{sfx}", f"1M 1080p tile {ts} train step B3 repeat",
              g_table, b3.tile_raster_bwd(*bwd))
    log(f"{tag} kernels alone (CUDA events): B2 {out['ms_b2']:.3f} ms, B3 "
        f"{out['ms_b3']:.3f} ms")

    out["ms_b2_plain"], (prgb, ptrans, pckpt, pnproc) = host_ms(
        lambda: b1.tile_raster_fwd_train_plain(*targs))
    key = f"1M 1080p tile {ts} train step B2"
    chk.close(f"B2{sfx}", f"{key} rgb", rgb, prgb)
    chk.close(f"B2{sfx}", f"{key} T", trans, ptrans)
    chk.equal(f"B2{sfx}", f"{key} nproc", nproc, pnproc)
    chk.equal(f"B2{sfx}", f"{key} ckpt", ckpt, pckpt)
    del prgb, ptrans, pckpt, pnproc
    out["ms_b3_plain"], pg = host_ms(lambda: b3.tile_raster_bwd_plain(*bwd))
    chk.columns(f"B3{sfx}", f"1M 1080p tile {ts} train step B3 g_table",
                g_table, pg)
    log(f"{tag} plain versions (host clock): B2 {out['ms_b2_plain']:.3f} "
        f"ms, B3 {out['ms_b3_plain']:.3f} ms")

    rows, frags = needed(f"B2, B3 tile {ts}", bs.table, bs.tile_starts,
                         bs.tile_counts, nproc, cfg)
    ntile, pixels, dpad = cfg.num_tiles, ts * ts, bs.table.shape[1]
    seg_bytes = (2 * ntile + 1) * 4
    ckpt_bytes = b1.ckpt_rows(pixels) * dpad * 4
    out["bound_b2"] = bound(f"B2 tile {ts}", frags * FLOPS_PER_FRAGMENT,
                            rows * BLEND_ATTR_BYTES + ntile * pixels * 4 * 4
                            + seg_bytes + ntile * 4 + ckpt_bytes)
    out["bound_b3"] = bound(f"B3 tile {ts}", frags * FLOPS_PER_FRAGMENT_B3,
                            rows * BLEND_ATTR_BYTES + ntile * pixels * 5 * 4
                            + seg_bytes + ntile * 4 + ckpt_bytes
                            + 16 * dpad * 4)
    dups = int(bs.tile_counts.sum())
    del splats, bs, g_table, pg, rgb, trans, ckpt, g_rgb, g_trans, bwd
    del targs

    # the classic backward has no atomics: two backwards on the same
    # parameters give the same bits
    def grads_once():
        for p in params:
            p.grad = None
        img = render(sc, view, proj, eye, cfg)
        (img * img).sum().backward()
        return grads_of(params)

    first = grads_once()
    same = all(torch.equal(a, b) for a, b in zip(first, grads_once()))
    log(f"{tag} gradients of two backwards equal bit for bit: {same}")
    if not same:
        raise AssertionError(f"tile {ts}: the classic gradient differs "
                             f"from run to run")
    del first

    if profile:
        # device busy share: kernel time per step (torch.profiler over two
        # steps) against the unprofiled step time below
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                train_step()
            torch.cuda.synchronize()
        kernel_rows = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_rows.sort(key=lambda e: -e.self_device_time_total)
        device_ms = sum(e.self_device_time_total for e in kernel_rows) / 2e3
        for e in kernel_rows[:8]:
            log(f"[profile] {e.self_device_time_total / 2e3:8.3f} ms/step "
                f"{e.count // 2:5d} launches  {e.key[:90]}")

    # the training path: counts at 0, TRAIN_STEPS steps, read
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        ms, loss = host_ms(train_step)
        step_ms.append(ms)
    out["counts"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_step = float(np.mean(step_ms))
    log(f"{tag} 1M SH3 {FULL_W}x{FULL_H} tile {ts} ({ntile} tiles, {dups} "
        f"rows listed, {rows} blended) fwd+bwd+update steps "
        f"{[f'{m:.3f}' for m in step_ms]} ms -> {ms_step:.3f} ms/step, "
        f"{FULL_W * FULL_H / ms_step / 1e3:.3f} Mpix/s, loss "
        f"{float(loss.detach()):.6g}, peak memory {peak:.3f} GiB, "
        f"launches {out['counts']}; {smi}")
    if profile:
        log(f"{tag} device kernel time {device_ms:.3f} ms/step (profiler) "
            f"-> busy {device_ms / ms_step:.3f}, idle "
            f"{1 - device_ms / ms_step:.3f} of the unprofiled step")
    want = {**no_launch, "B2": TRAIN_STEPS, "B3": TRAIN_STEPS}
    if out["counts"] != want:
        raise AssertionError(f"tile {ts}: {TRAIN_STEPS} steps launched "
                             f"{out['counts']}")
    for name, p in zip(FIELDS, params):
        g = p.grad
        ok = g is not None and bool(torch.isfinite(g).all()) \
            and float(g.abs().max()) > 0
        log(f"{tag} grad {name}: finite and nonzero {ok}, max|g| "
            f"{float(g.abs().max()) if g is not None else 0.0:.4g}")
        if not ok:
            raise AssertionError(f"tile {ts}: the {name} gradient is zero "
                                 f"or not finite")
    return out


def garden_cell(chk, zero_counts, counts, no_launch):
    """Phase 9: the JAX bench.py garden workload on the fused path, with
    the classic path on the same scene and pose beside it."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.models import (
        GaussianData,
        random_scene,
    )
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops import fused as fz
    from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import render_with_aux
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    dev = torch.device(DEVICE)
    cam = Camera(h=GARDEN_H, w=GARDEN_W)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 11.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = cam.get_project_matrix()
    t0 = time.perf_counter()
    scene = random_scene(GARDEN_SPLATS, sh_degree=3, seed=0, extent=6.0,
                         mean_scale=0.012, anisotropy=1.0,
                         opacity_mix=True).pad_to_multiple(1024).to(dev)
    log(f"[garden] scene of {len(scene)} splats made in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cfg0 = RenderConfig(width=GARDEN_W, height=GARDEN_H)
    cfg = autotune(scene, [view], [proj], [eye], cfg0, probe=True,
                   fused=None)
    log(f"[garden] autotune(probe=True, fused=None) in "
        f"{time.perf_counter() - t0:.2f} s: fused {cfg.fused_grad}, K "
        f"{cfg.prefix_rows}, prefix_budget_rows {cfg.prefix_budget_rows}, "
        f"residual_budget_rows {cfg.residual_budget_rows}, "
        f"grad_budget_rows {cfg.grad_budget_rows}, "
        f"grad_residual_budget_rows {cfg.grad_residual_budget_rows}, "
        f"table_budget_rows {cfg.table_budget_rows}")
    if not cfg.fused_grad:
        cfg = autotune(scene, [view], [proj], [eye], cfg0, probe=True,
                       fused=True)
        log(f"[garden] the tuner declined the fused path; FORCED for this "
            f"phase: K {cfg.prefix_rows}, budgets {cfg.prefix_budget_rows}"
            f" / {cfg.residual_budget_rows} / {cfg.grad_budget_rows} / "
            f"{cfg.grad_residual_budget_rows}")
    if cfg.prefix_rows == 0:
        raise AssertionError("garden: the fused config has no residual "
                             "pass (K = 0), so B4 would never run")
    classic = cfg.with_(fused_grad=False)

    sc = GaussianData(*(getattr(scene, f).detach().clone()
                        .requires_grad_(True) for f in FIELDS))
    params = [getattr(sc, f) for f in FIELDS]
    del scene
    out = {}
    for name, c, staged, stages, want in (
            ("fused", cfg, fused_staged_step, FUSED_STAGES,
             {**no_launch, "B2": 1, "B4": 1, "B5": 2}),
            ("classic", classic, classic_staged_step, CLASSIC_STAGES,
             {**no_launch, "B2": 1, "B3": 1})):
        for _ in range(2):  # warm-up
            sgd_step(sc, params, view, proj, eye, c)
        torch.cuda.synchronize()
        stage_ms, stage_sum = staged_means(
            lambda: staged(sc, params, view, proj, eye, c), stages)
        log(f"[garden] {name} stages (CUDA events, mean of 3): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stage_ms.items())
            + f"; sum {stage_sum:.3f} ms")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(TRAIN_STEPS):
            ms, (loss, aux) = host_ms(
                lambda: sgd_step(sc, params, view, proj, eye, c))
            step_ms.append(ms)
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms_step = float(np.mean(step_ms))
        diag = {k: float(aux[k]) for k in ("num_duplicates", "truncated",
                                           "grad_rows_needed",
                                           "grad_rows_dropped") if k in aux}
        log(f"[garden] {name} {GARDEN_SPLATS / 1e6:.1f}M SH3 "
            f"{GARDEN_W}x{GARDEN_H} steps "
            f"{[f'{m:.3f}' for m in step_ms]} ms -> {ms_step:.3f} ms/step, "
            f"{GARDEN_W * GARDEN_H / ms_step / 1e3:.3f} Mpix/s, loss "
            f"{float(loss.detach()):.6g}, peak memory {peak:.3f} GiB, "
            f"{diag}, launches {got}")
        per_step = {k: v * TRAIN_STEPS for k, v in want.items()}
        if got != per_step:
            raise AssertionError(f"garden {name}: launches {got}, want "
                                 f"{per_step}")
        if diag["truncated"] != 0 or diag.get("grad_rows_dropped", 0) != 0:
            raise AssertionError(f"garden {name}: rows dropped {diag}")
        out[name] = got

    # fused against classic gradients on the same parameters, f32 fold.
    # The classic fold (binning.fold_table_grad: a row gather in
    # splat-major order, one segment sum per splat) has no atomics:
    # classic again must give the same bits.  The fused fold (ops/fold.py,
    # f64 atomics rounded to f32) is run twice too, and whether it repeats
    # is printed.  With K = 0 the fused pass blends exactly the
    # classic rows; the tuned K also stops pass 1 at row K where the
    # classic blend runs on to the end of the window in which a tile
    # saturates (rows behind T < 1e-4).  Gate: 1e-3.
    single = cfg.with_(prefix_rows=0, prefix_budget_rows=0,
                       residual_budget_rows=0, grad_budget_rows=0,
                       grad_residual_budget_rows=0)
    grads = {}
    fused_k = f"fused K={cfg.prefix_rows}"
    for name, c in (("classic", classic), ("classic again", classic),
                    ("fused K=0", single), (fused_k, cfg),
                    (fused_k + " again", cfg)):
        for p in params:
            p.grad = None
        img = render_with_aux(sc, view, proj, eye,
                              c.with_(grad_fold_bf16=False))[0]
        (img * img).sum().backward()
        grads[name] = grads_of(params)
    gc_all = grads.pop("classic")
    g_again = grads.pop(fused_k + " again")
    for name, g_all in grads.items():
        for f, gf, gc in zip(FIELDS, g_all, gc_all):
            scale = float(gc.abs().max())
            err = float((gf - gc).abs().max())
            log(f"[garden] grad {f}: max|{name} - classic| {err:.4g}, "
                f"max|g| {scale:.4g}, ratio "
                f"{err / scale if scale else 0.0:.3e} "
                + ("(must be 0)" if name == "classic again" else
                   "(tol 1e-3)"))
            if not (scale > 0 and err <= 1e-3 * scale
                    and bool(torch.isfinite(gf).all())):
                raise AssertionError(f"garden: {name} {f} gradient "
                                     f"disagrees with classic")
            if name == "classic again" and not torch.equal(gf, gc):
                raise AssertionError(f"garden: the classic {f} gradient "
                                     f"changed between two backwards")
    log("[garden] fused (f64 id fold) again bit-equal: " + ", ".join(
        f"{f} {bool(torch.equal(a, b))}"
        for f, a, b in zip(FIELDS, g_again, grads[fused_k])))
    del grads, gc_all, g_again

    # the classic fold alone, on a classic step's own duplicates: the
    # segment sum against one index_add_ (f32 atomics), bf16 on and off
    with torch.no_grad():
        splats = project(sc, view, proj, eye, classic)
        sid, _, _, pos, offsets = binning._sorted_rows(splats, classic, 0,
                                                       None, 1)
        del splats
    n = len(sc.xyz)
    cap = min(int(sid.shape[0]), classic.table_budget_rows
              or classic.table_budget_factor * n)
    sid = sid[:cap]
    gen = torch.Generator(device=dev).manual_seed(3)
    g_tab = torch.randn((binning.TABLE_WIDTH, cap + binning.TABLE_PAD),
                        generator=gen, device=dev)
    for bf16 in (True, False):
        def fold():
            return binning.fold_table_grad(g_tab, pos, offsets, cap, bf16)

        new = fold()
        old = fold_index_add(g_tab, sid, n, bf16)
        ms_new, again = cuda_ms(fold, 10)
        ms_old, _ = cuda_ms(lambda: fold_index_add(g_tab, sid, n, bf16), 10)
        log(f"[garden] classic fold alone (CUDA events, bf16 {bf16}, "
            f"{cap} rows onto {n} splats): segment sum {ms_new:.3f} ms, "
            f"index_add_ {ms_old:.3f} ms; max|segment - index_add_| "
            f"{float((new - old).abs().max()):.3e} of max "
            f"{float(old.abs().max()):.3e}; segment sum repeats bit for "
            f"bit {bool(torch.equal(new, again))}")
        if not torch.equal(new, again):
            raise AssertionError("the classic fold changed between runs")
    del g_tab, sid, pos, offsets, new, old, again

    # serving: three frames under the fused config
    zero_counts()
    frame_ms = []
    with torch.no_grad():
        for _ in range(3):
            ms, (img, aux) = host_ms(
                lambda: render_with_aux(sc, view, proj, eye, cfg))
            frame_ms.append(ms)
    got = counts()
    log(f"[garden] fused serving frames {[f'{m:.3f}' for m in frame_ms]} ms"
        f" -> {float(np.mean(frame_ms)):.3f} ms/frame, launches {got}")
    if got != {**no_launch, "B1": 3, "B4": 3}:
        raise AssertionError(f"garden serving launched {got}")
    img_np = img.cpu().numpy()
    if img_np.shape != (GARDEN_H, GARDEN_W, 3) \
            or not np.isfinite(img_np).all() or not img_np.std() > 0.01:
        raise AssertionError("garden frame is not a finite image")

    # B4 and B5 alone on one fused step's own inputs
    with torch.no_grad():
        splats = project(sc, view, proj, eye, cfg)
        pres = binning.bin_splats_presort(splats, cfg)
        f = fz._forward(cfg, cfg.tiles_y, 1, pres.table_src,
                        pres.rows_sorted, pres.starts_full, 0, train=True)
    del splats, pres
    ntile = cfg.num_tiles
    seeded = (f["table2"], f["rstarts_c"], f["rcounts"], f["trans1"], 0,
              cfg)
    b1.tile_raster_fwd_seeded(*seeded, train=True)  # warm-up
    ms_b4, (rgb2, trans2, ckpt2, nproc2) = cuda_ms(
        lambda: b1.tile_raster_fwd_seeded(*seeded, train=True), 10)
    ms_b4_plain, plain = host_ms(
        lambda: b1.tile_raster_fwd_seeded_plain(*seeded, train=True))
    chk.close("B4", "garden step B4 rgb", rgb2, plain[0])
    for name, a, b in zip(("T", "ckpt", "nproc"), (trans2, ckpt2, nproc2),
                          plain[1:]):
        chk.equal("B4", f"garden step B4 {name}", a, b)
    del plain
    g_rgb, g_trans = image_cotangents(f["rgb"], f["trans"], cfg)
    np2, goff2, _, _ = fz._regions(f["rstarts_c"], f["rcounts"], nproc2,
                                   fz._grad_budget2(cfg, ntile), ntile)
    np1, goff1, _, _ = fz._regions(
        f["pstarts_c"], f["pcounts"], f["nproc1"],
        fz._grad_budget(cfg, f["table1"].shape[1], ntile), ntile)
    passes = {
        "pass 2": (f["table2"], f["rstarts_c"], f["rcounts"], np2, goff2,
                   ckpt2, 0, g_rgb, g_trans, f["trans"],
                   torch.zeros_like(f["trans"]), f["trans1"],
                   fz._grad_budget2(cfg, ntile), cfg),
        "pass 1": (f["table1"], f["pstarts_c"], f["pcounts"], np1, goff1,
                   f["ckpt1"], 0, g_rgb, g_trans, f["trans"],
                   (g_rgb * rgb2).sum(dim=-1), torch.ones_like(f["trans"]),
                   fz._grad_budget(cfg, f["table1"].shape[1], ntile), cfg)}
    ms_b5 = ms_b5_plain = 0.0
    rows, frags = {}, {}
    b5_bytes = 0
    seg_bytes = (2 * ntile + 1) * 4
    for name, args in passes.items():
        b3.tile_raster_bwd_fused(*args)  # warm-up
        ms, g = cuda_ms(lambda: b3.tile_raster_bwd_fused(*args), 5)
        chk.equal("B5", f"garden step B5 {name} repeat", g,
                  b3.tile_raster_bwd_fused(*args))
        ms_plain, pg = host_ms(lambda: b3.tile_raster_bwd_fused_plain(*args))
        chk.columns("B5", f"garden step B5 {name}", g, pg)
        if name == "pass 1":
            n = len(sc.xyz)
            ms_f, a = cuda_ms(lambda: fz.fold_rows_by_id(g, n, True), 10)
            ms_s, b = cuda_ms(lambda: fold_by_id_sorted(g, n, True), 10)
            log(f"[garden] fused fold alone on pass 1's {g.shape[1]} rows "
                f"(CUDA events, bf16): f64 index_add_ {ms_f:.3f} ms, "
                f"sorted f64 segment sum {ms_s:.3f} ms; index_add_ repeats "
                f"{bool(torch.equal(a, fz.fold_rows_by_id(g, n, True)))}, "
                f"max|index_add_ - sorted| {float((a - b).abs().max()):.3e}")
            del a, b
        del g, pg
        ms_b5 += ms / 2
        ms_b5_plain += ms_plain / 2
        rows[name], frags[name] = needed(f"B5 {name}", *args[:4], cfg)
        # table rows and ids read, 9 gradients + id written per row; g_rgb,
        # g_trans, out_trans, suffix and t_entry per pixel; segments,
        # nproc, goff; the checkpoint buffer
        b5_bytes += rows[name] * (BLEND_ATTR_BYTES + 4 + 10 * 4) \
            + ntile * 256 * 7 * 4 + seg_bytes + 2 * ntile * 4 \
            + args[5].numel() * 4
    rows_b4, frags_b4 = needed("B4", f["table2"], f["rstarts_c"],
                               f["rcounts"], nproc2, cfg)
    log(f"[garden] kernels alone (CUDA events): B4 {ms_b4:.3f} ms, B5 "
        f"{ms_b5:.3f} ms per launch; plain (host clock): B4 "
        f"{ms_b4_plain:.3f} ms, B5 {ms_b5_plain:.3f} ms per launch; rows "
        f"blended: pass 1 {rows['pass 1']}, pass 2 {rows_b4}; pass 2 "
        f"listed {int(f['rcounts'].sum())} rows in "
        f"{int((f['rcounts'] > 0).sum())} tiles, "
        f"{int((f['pcounts'] >= cfg.prefix_rows).sum())} tiles filled "
        f"their {cfg.prefix_rows}-row prefix")
    bound_b4 = bound("B4", frags_b4 * FLOPS_PER_FRAGMENT,
                     rows_b4 * BLEND_ATTR_BYTES + ntile * 256 * 5 * 4
                     + seg_bytes + ntile * 4 + ckpt2.numel() * 4)
    b5 = bound("B5 (both launches)",
               (frags["pass 1"] + frags["pass 2"]) * FLOPS_PER_FRAGMENT_B3,
               b5_bytes)
    return {"counts": out["fused"], "ms_b4": ms_b4,
            "ms_b4_plain": ms_b4_plain, "bound_b4": bound_b4,
            "ms_b5": ms_b5, "ms_b5_plain": ms_b5_plain,
            "bound_b5": (b5[0] / 2, b5[1])}


def fold_index_add(g, sid, n, fold_bf16):
    """The classic fold as one f32 ``index_add_`` (CUDA atomics) of the
    table's columns onto splats ``sid``: the library call the segment sum
    (binning.fold_table_grad) is timed against."""
    from gaussiansplattingviewer_tpu_torch.ops import binning

    rows = g[:binning.GRAD_WIDTH, :sid.shape[0]].T
    if fold_bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n, binning.TABLE_WIDTH), dtype=torch.float32,
                      device=g.device)
    out[:, :binning.GRAD_WIDTH].index_add_(0, sid, rows)
    return out


def fold_by_id_sorted(g_soa, n, fold_bf16):
    """ops/fold.py's f64 id fold with a stable sort by id and one f64
    segment sum per splat in place of its f64 ``index_add_``."""
    from gaussiansplattingviewer_tpu_torch.ops import binning

    ids = g_soa[binning.COL_COUNT].to(torch.int32)
    ids_sorted, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        ids_sorted, torch.arange(n + 1, dtype=torch.int32,
                                 device=ids.device))
    rows = g_soa[:binning.GRAD_WIDTH].index_select(1, perm)
    if fold_bf16:
        rows = rows.to(torch.bfloat16)
    out = torch.zeros((n, binning.TABLE_WIDTH), dtype=torch.float32,
                      device=g_soa.device)
    out[:, :binning.GRAD_WIDTH] = torch.segment_reduce(
        rows.to(torch.float64).T.contiguous(), "sum", offsets=offsets,
        axis=0, unsafe=True)
    return out


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


SHARDS = 4
SHARD_MODES = {"contiguous": {}, "interleaved": dict(row_stride=SHARDS),
               "precull": dict(precull_budget_factor=2.5)}


def sharded_cell(chk, zero_counts, counts, no_launch, scene, view, proj, eye,
                 cfg):
    """Phase 8: the tile-row-sharded render and train step
    (parallel/sharded_render.py) on the 1M scene at full size.  The 4
    shards' band programs run one after another by index (one card), the
    distributed step in a one-rank NCCL group."""
    from gaussiansplattingviewer_tpu_torch import parallel
    from gaussiansplattingviewer_tpu_torch.models import GaussianData
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import render
    from gaussiansplattingviewer_tpu_torch.parallel import sharded_render as sr

    t_phase = time.perf_counter()
    dev = scene.xyz.device
    rows = sr._rows_per_shard(cfg, SHARDS)
    with torch.no_grad():
        ref = render(scene, view, proj, eye, cfg)
        # B1 alone on the unsharded frame's table, as on each band's below
        bs = binning.bin_splats(project(scene, view, proj, eye, cfg), cfg)
        full_args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        b1.tile_raster_fwd(*full_args)  # warm-up
        ms_full, _ = cuda_ms(lambda: b1.tile_raster_fwd(*full_args), 10)
    del bs, full_args
    log(f"[sharded] {SHARDS} shards of {rows} tile rows each "
        f"({cfg.tiles_y} rows, {cfg.tiles_x} tiles per row); unsharded B1 "
        f"{ms_full:.3f} ms (CUDA events)")

    # the bands' tables place each tile's rows at other columns than the
    # single table does, so the 256-row windows (aligned to 128 table
    # columns) end at other rows and a tile's early stop (T < 1e-4 after a
    # window) can blend more or fewer rows behind T < 1e-4: with the early
    # stop the bands agree with render() to early_stop_transmittance; with
    # it off both blend every listed row and agree to 1e-5 (bit for bit)
    exact = cfg.with_(early_stop_transmittance=0.0)
    with torch.no_grad():
        ref_exact = render(scene, view, proj, eye, exact)
    captured = []
    orig_blend = sr.blend_tiles

    def capture(*a):
        captured.append(a)
        return orig_blend(*a)

    def bands(c, kw):
        """The 4 band programs under config c -> (image, auxes, ms,
        launches)."""
        out = torch.zeros((c.height, c.width, 3), device=dev)
        auxes = []
        zero_counts()
        with torch.no_grad():
            t0 = time.perf_counter()
            for idx in range(SHARDS):
                band, aux = sr._render_band(scene, view, proj, eye, c, rows,
                                            idx=idx, return_aux=True, **kw)
                y = sr.band_pixel_rows(c, SHARDS, idx,
                                       "row_stride" in kw).to(dev)
                live = y < c.height
                out[y[live]] = band[live, :c.width]
                auxes.append({k: int(v) for k, v in aux.items()})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return out, auxes, ms, counts()

    for name, kw in SHARD_MODES.items():
        captured.clear()
        sr.blend_tiles = capture
        try:
            out, auxes, ms_frame, got = bands(cfg, kw)
        finally:
            sr.blend_tiles = orig_blend
        out_x, auxes_x, _, got_x = bands(exact, kw)
        for c, img, want, aux_list, launched, tag, t in (
                (cfg, out, ref, auxes, got, "early stop",
                 cfg.early_stop_transmittance),
                (exact, out_x, ref_exact, auxes_x, got_x, "no early stop",
                 1e-5)):
            tol_c = t * max(1.0, float(want.abs().max()))
            err = float((img - want).abs().max())
            log(f"[sharded] {name}, {tag}: image max|bands - render()| "
                f"{err:.3e} (tol {tol_c:.1e}), bit-equal "
                f"{bool(torch.equal(img, want))}, pixels differing "
                f"{int((img != want).any(dim=-1).sum())}, launches "
                f"{launched}")
            if launched != {**no_launch, "B1": SHARDS}:
                raise AssertionError(f"sharded {name}: launches {launched},"
                                     f" want B1 {SHARDS}")
            if not err <= tol_c:
                raise AssertionError(f"sharded {name} ({tag}): bands "
                                     f"disagree with render()")
            for idx, a in enumerate(aux_list):
                if a["dropped"] or a["truncated"]:
                    raise AssertionError(f"sharded {name} band {idx}: "
                                         f"splats dropped {a}")
        log(f"[sharded] {name}: 4 band programs {ms_frame:.3f} ms (host "
            f"clock)")
        band_ms = []
        for idx, a in enumerate(captured):
            cfg_b, local_rows, stride, table, starts, cnts, row0 = a[:7]
            args = (table, starts, cnts, row0, cfg_b, local_rows, stride)
            with torch.no_grad():
                ms, (rgb, trans) = cuda_ms(lambda: b1.tile_raster_fwd(*args),
                                           10)
                if idx == 1:
                    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
                    chk.close("B1", f"sharded {name} band 1 B1 rgb", rgb,
                              prgb)
                    chk.close("B1", f"sharded {name} band 1 B1 T", trans,
                              ptrans)
            band_ms.append(ms)
        for idx, (a, ms) in enumerate(zip(auxes, band_ms)):
            log(f"[sharded] {name} band {idx}: kept {a['kept']} splats, "
                f"dropped {a['dropped']}, num_duplicates "
                f"{a['num_duplicates']}, truncated {a['truncated']}, "
                f"overflow {a['overflow']}, B1 {ms:.3f} ms")
        log(f"[sharded] {name}: B1 per band {[f'{m:.3f}' for m in band_ms]}"
            f" ms, sum {sum(band_ms):.3f} ms against unsharded "
            f"{ms_full:.3f} ms")
    captured.clear()

    # gradients: the full step's loss sum(img^2) through the 4 contiguous
    # bands (4 backwards accumulating) against the single render, f32 fold
    cfg32 = cfg.with_(grad_fold_bf16=False)

    def leaves():
        return GaussianData(*(getattr(scene, f).detach().clone()
                              .requires_grad_(True) for f in FIELDS))

    sc = leaves()
    zero_counts()
    for idx in range(SHARDS):
        band = sr._render_band(sc, view, proj, eye, cfg32, rows, idx=idx)
        y = sr.band_pixel_rows(cfg32, SHARDS, idx).to(dev)
        live = y < cfg.height
        crop = band[live, :cfg.width]
        (crop * crop).sum().backward()
    got = counts()
    if got != {**no_launch, "B2": SHARDS, "B3": SHARDS}:
        raise AssertionError(f"sharded gradients: launches {got}")
    g_bands = grads_of([getattr(sc, f) for f in FIELDS])
    g_single = []
    for _ in range(2):
        sc1 = leaves()
        img = render(sc1, view, proj, eye, cfg32)
        (img * img).sum().backward()
        g_single.append(grads_of([getattr(sc1, f) for f in FIELDS]))
    for f, gb, g1, g2 in zip(FIELDS, g_bands, *g_single):
        scale = float(g1.abs().max())
        err = float((gb - g1).abs().max())
        same = bool(torch.equal(g1, g2))
        log(f"[sharded] grad {f}: max|4 bands - single| {err:.4g}, max|g| "
            f"{scale:.4g}, ratio {err / scale if scale else 0.0:.3e} (tol "
            f"1e-3); single render again bit-equal {same}")
        if not (scale > 0 and err <= 1e-3 * scale):
            raise AssertionError(f"sharded {f} gradient disagrees")
        if not same:
            raise AssertionError(f"1M classic {f} gradient changed between "
                                 f"two backwards")
    del sc, sc1, g_bands, g_single, img

    # the distributed step in a one-rank NCCL group
    import torch.distributed as dist

    parallel.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                    device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = parallel.make_mesh(1)
        with torch.no_grad():
            target = 0.7 * ref
        for name, kw in (("replicated", {}),
                         ("shard_splats + exchange",
                          dict(shard_splats=True, exchange=True))):
            step = parallel.make_sharded_train_step(mesh, cfg, **kw)
            sc = leaves()
            opt, losses, step_ms = None, [], []
            zero_counts()
            for _ in range(3):
                ms, (sc, opt, loss) = host_ms(
                    lambda: step(sc, opt, view, proj, eye, target))
                losses.append(float(loss))
                step_ms.append(ms)
            got = counts()
            log(f"[sharded] NCCL world 1, {name}: losses {losses}, steps "
                f"{[f'{m:.3f}' for m in step_ms]} ms, launches {got}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"NCCL step {name}: the loss did not "
                                     f"fall")
            if got != {**no_launch, "B2": 3, "B3": 3}:
                raise AssertionError(f"NCCL step {name}: launches {got}")
            del sc, opt
    finally:
        dist.destroy_process_group()
    log(f"[sharded] phase {time.perf_counter() - t_phase:.2f} s")


def fused_serving(cfg, prefix_rows):
    """cfg on the fused serving path (B1 then B4 with train=False) with a
    prefix of ``prefix_rows`` rows per tile."""
    return cfg.with_(fused_grad=True, prefix_rows=prefix_rows,
                     residual_budget_rows=FUSED_RESIDUAL_ROWS)


def tile_kernels_vs_plain(chk, tag, splats, bs, cfg, row_offset=0,
                          local_rows=None, row_stride=1):
    """B1, B2 and B3 on a binned table (kernels_vs_plain) and B4
    (train=False) on the fused serving path's own pass-2 inputs against
    their plain versions, at cfg.tile_size; returns the rows pass 2
    listed."""
    from gaussiansplattingviewer_tpu_torch.ops import binning, fused
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    ts = cfg.tile_size
    kernels_vs_plain(chk, tag, bs, cfg, row_offset,
                     () if local_rows is None else (local_rows, row_stride))
    if local_rows is None:
        local_rows = cfg.tiles_y
    cf = fused_serving(cfg, GOLDEN_PREFIX[ts])
    pres = binning.bin_splats_presort(splats, cf, row_offset, local_rows,
                                      row_stride)
    f = fused._forward(cf, local_rows, row_stride, pres.table_src,
                       pres.rows_sorted, pres.starts_full, row_offset,
                       train=False)
    seeded = (f["table2"], f["rstarts_c"], f["rcounts"], f["trans1"],
              row_offset, cf, local_rows, row_stride)
    rgb2, trans2 = b1.tile_raster_fwd_seeded(*seeded)
    torch.cuda.synchronize()
    prgb2, ptrans2 = b1.tile_raster_fwd_seeded_plain(*seeded)
    chk.close(f"B4 t{ts}", f"{tag} B4 inference rgb", rgb2, prgb2)
    chk.equal(f"B4 t{ts}", f"{tag} B4 inference T", trans2, ptrans2)
    return int(f["rcounts"].sum())


def training_tiles_refused(counts):
    """CUDA tensors at tile 8 through the fused training kernels (B4
    train, B5) raise (JAX's fused path runs only through Pallas, whose
    train kernel lays its checkpoint out for 256 pixels), and at tile 24
    through every kernel; nothing launches."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    z = dict(device=DEVICE)
    table = torch.zeros((16, 600), **z)
    before = counts()
    for ts, width, height in ((8, 64, 48), (24, 48, 48)):
        cfg = RenderConfig(width=width, height=height, tile_size=ts)
        nt, p = cfg.num_tiles, ts * ts
        starts = torch.zeros(nt + 1, dtype=torch.int32, **z)
        cnt = torch.zeros(nt, dtype=torch.int32, **z)
        per_tile = torch.ones((nt, p), **z)
        ckpt = torch.zeros((b1.ckpt_rows(p), 600), **z)
        g_rgb = torch.zeros((nt, p, 3), **z)
        calls = {
            "B4 train": lambda: b1.tile_raster_fwd_seeded(
                table, starts, cnt, per_tile, 0, cfg, train=True),
            "B5": lambda: b3.tile_raster_bwd_fused(
                table, starts, cnt, cnt, cnt, ckpt, 0, g_rgb, per_tile,
                per_tile, per_tile, per_tile, 1024, cfg)}
        if ts == 24:
            calls.update({
                "B1": lambda: b1.tile_raster_fwd(table, starts, cnt, 0, cfg),
                "B2": lambda: b1.tile_raster_fwd_train(table, starts, cnt, 0,
                                                       cfg),
                "B4": lambda: b1.tile_raster_fwd_seeded(
                    table, starts, cnt, per_tile, 0, cfg),
                "B3": lambda: b3.tile_raster_bwd(
                    table, starts, cnt, cnt, ckpt, 0, g_rgb, per_tile,
                    per_tile, cfg)})
        for name, call in calls.items():
            try:
                call()
            except ValueError as e:
                log(f"[tiles] {name} at tile {ts} on the card refused: "
                    f"{str(e)[:160]}...")
            else:
                raise AssertionError(f"{name} ran at tile {ts} on the card")
    if counts() != before:
        raise AssertionError(f"a refused kernel launched: {counts()}")


def served_at_tile(chk, zero_counts, counts, no_launch, scene, view, proj,
                   eye, cfg, smi):
    """The 1M frame at cfg.tile_size: 3 frames through render() (B1 once
    each), and B1 alone on the frame's table against its plain version,
    its bound from the fragments the frame needs.  Returns its numbers and
    the last frame."""
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import (
        render,
        render_with_aux,
    )

    ts, dev = cfg.tile_size, scene.xyz.device
    pixels, ntile = ts * ts, cfg.num_tiles
    seg_bytes = (2 * ntile + 1) * 4
    out = {}
    with torch.no_grad():
        render(scene, view, proj, eye, cfg)  # warm-up
        zero_counts()
        frame_ms = []
        for _ in range(3):
            ms, (img, aux) = host_ms(
                lambda: render_with_aux(scene, view, proj, eye, cfg))
            frame_ms.append(ms)
        out["launches"] = counts()["B1"]
        if counts() != {**no_launch, "B1": 3}:
            raise AssertionError(f"tile {ts}: 3 frames launched {counts()}")
        img_np = img.cpu().numpy()
        if img_np.shape != (FULL_H, FULL_W, 3) \
                or not np.isfinite(img_np).all() or not img_np.std() > 0.01:
            raise AssertionError(f"tile {ts}: the frame is not an image")
        if int(aux["truncated"]) or int(aux["overflow"]):
            raise AssertionError(f"tile {ts}: rows dropped {aux}")

        bs = binning.bin_splats(project(scene, view, proj, eye, cfg), cfg)
        args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        b1.tile_raster_fwd(*args)  # warm-up
        out["ms"], (rgb, trans) = cuda_ms(lambda: b1.tile_raster_fwd(*args),
                                          10)
        px, py = b1.tile_pixel_grid(cfg, cfg.tiles_y, device=dev)
        out["plain_ms"], (prgb, ptrans, nproc) = host_ms(
            lambda: b1.blend_tiles_plain(bs.table, bs.tile_starts[:-1],
                                         bs.tile_counts, px, py, cfg))
        key = f"B1 t{ts}"
        chk.close(key, f"1M 1080p tile {ts} B1 rgb", rgb, prgb)
        chk.close(key, f"1M 1080p tile {ts} B1 T", trans, ptrans)
        rows, frags = needed(f"B1 tile {ts}", bs.table, bs.tile_starts,
                             bs.tile_counts, nproc, cfg)
        out["bound"] = bound(
            f"B1 tile {ts}", frags * FLOPS_PER_FRAGMENT,
            rows * BLEND_ATTR_BYTES + ntile * pixels * 4 * 4 + seg_bytes)
        dups = int(bs.tile_counts.sum())
        del bs, args, rgb, trans, prgb, ptrans, px, py
    log(f"[tiles] 1M SH3 {FULL_W}x{FULL_H} tile {ts} ({ntile} tiles, {dups} "
        f"rows listed, {rows} blended): frames "
        f"{[f'{m:.3f}' for m in frame_ms]} ms, B1 {out['ms']:.3f} ms "
        f"(CUDA events), plain {out['plain_ms']:.3f} ms, bound "
        f"{out['bound'][0]:.4f} ms; {smi}")
    out["img"] = img
    return out


def fused_served_at_tile(chk, zero_counts, counts, no_launch, scene, view,
                         proj, eye, cfg, img, smi):
    """The 1M frame on the fused serving path at cfg.tile_size: 2 frames
    (B1 and B4 once each) against the classic frame ``img``, and B4 alone
    on its pass-2 inputs against its plain version, its bound from the
    fragments pass 2 needs."""
    from gaussiansplattingviewer_tpu_torch.ops import binning, fused
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import (
        render,
        render_with_aux,
    )

    ts, dev = cfg.tile_size, scene.xyz.device
    pixels, ntile = ts * ts, cfg.num_tiles
    seg_bytes = (2 * ntile + 1) * 4
    out = {}
    with torch.no_grad():
        cf = fused_serving(cfg, FULL_PREFIX[ts])
        render(scene, view, proj, eye, cf)  # warm-up
        zero_counts()
        fused_ms = []
        for _ in range(2):
            ms, (fimg, faux) = host_ms(
                lambda: render_with_aux(scene, view, proj, eye, cf))
            fused_ms.append(ms)
        out["b4_launches"] = counts()["B4"]
        if counts() != {**no_launch, "B1": 2, "B4": 2}:
            raise AssertionError(f"tile {ts}: 2 fused frames launched "
                                 f"{counts()}")
        if int(faux["truncated"]):
            raise AssertionError(f"tile {ts} fused: rows dropped {faux}")
        fused_err = float((fimg - img).abs().max())
        pres = binning.bin_splats_presort(project(scene, view, proj, eye, cf),
                                          cf)
        f = fused._forward(cf, cf.tiles_y, 1, pres.table_src,
                           pres.rows_sorted, pres.starts_full, 0,
                           train=False)
        del pres
        seeded = (f["table2"], f["rstarts_c"], f["rcounts"], f["trans1"], 0,
                  cf)
        b1.tile_raster_fwd_seeded(*seeded)  # warm-up
        out["b4_ms"], (rgb2, trans2) = cuda_ms(
            lambda: b1.tile_raster_fwd_seeded(*seeded), 10)
        px, py = b1.tile_pixel_grid(cf, cf.tiles_y, device=dev)
        out["b4_plain_ms"], (prgb2, ptrans2, nproc2) = host_ms(
            lambda: b1.blend_tiles_plain(f["table2"], f["rstarts_c"][:-1],
                                         f["rcounts"], px, py, cf,
                                         t_init=f["trans1"]))
        key = "B4" if ts == 16 else f"B4 t{ts}"
        chk.close(key, f"1M 1080p tile {ts} B4 inference rgb", rgb2, prgb2)
        chk.equal(key, f"1M 1080p tile {ts} B4 inference T", trans2, ptrans2)
        rows2, frags2 = needed(f"B4 inference tile {ts}", f["table2"],
                               f["rstarts_c"], f["rcounts"], nproc2, cf)
        out["b4_bound"] = bound(
            f"B4 inference tile {ts}", frags2 * FLOPS_PER_FRAGMENT,
            rows2 * BLEND_ATTR_BYTES + ntile * pixels * 5 * 4 + seg_bytes)
        del f, seeded, rgb2, trans2, prgb2, ptrans2, px, py
    log(f"[tiles] 1M SH3 {FULL_W}x{FULL_H} tile {ts} fused (K "
        f"{cf.prefix_rows}) frames {[f'{m:.3f}' for m in fused_ms]} ms, "
        f"max|fused - classic| {fused_err:.3e}, pass 2 {rows2} rows blended,"
        f" B4 {out['b4_ms']:.3f} ms, plain {out['b4_plain_ms']:.3f} ms, "
        f"bound {out['b4_bound'][0]:.4f} ms; {smi}")
    return out


def colmap_dir(path, n, dist):
    """A COLMAP sparse dir of n poses about ``dist`` from the origin and
    looking at it (tests/test_apps.py's poses, moved out)."""
    path.mkdir(parents=True, exist_ok=True)
    lines = ["# images.txt"]
    for i in range(n):
        q = np.array([0.02 * i, 0.01 * i, 1.0, 0.0])
        q /= np.linalg.norm(q)
        t = [0.1 * i, 0.05 * i, -dist]
        lines += [f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
                  f"1 im{i}.png", "0 0 1"]
    (path / "images.txt").write_text("\n".join(lines) + "\n")
    (path / "cameras.txt").write_text(
        "1 PINHOLE 1160 522 3443.9 3443.9 580 261\n")
    return path


def run_app(main, argv, zero_counts, counts, no_launch, want_b1, tag):
    """One app through its main(argv): exit 0 and B1 launched want_b1
    times; returns (seconds, captured stderr)."""
    err = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    for line in err.getvalue().splitlines():
        log(f"[apps] {tag}: {line}")
    log(f"[apps] {tag}: rc {rc} in {secs:.3f} s, launches {got}")
    if rc != 0:
        raise AssertionError(f"{tag} exited {rc}")
    if got != {**no_launch, "B1": want_b1}:
        raise AssertionError(f"{tag}: launches {got}, want B1 {want_b1}")
    return secs, err.getvalue()


def png_encoders(work, rgb8, disp16, smi):
    """The native PNG encoders (image_io's first choice) against PIL (its
    fallback) on one 1080p frame and one disparity map, both at zlib level
    6: host ms per image, mean of 3, and the decoded pixels equal."""
    import ctypes

    from PIL import Image

    from gaussiansplattingviewer_tpu_torch import native
    from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image

    lib = native.get_lib()
    for name, arr in (("rgb8", rgb8), ("disparity16", disp16)):
        data = np.ascontiguousarray(arr)
        h, w = arr.shape[:2]
        p_nat, p_pil = work / f"native_{name}.png", work / f"pil_{name}.png"
        if arr.dtype == np.uint8:
            write, ptr = lib.gsv_write_png_rgb8, ctypes.c_uint8
        else:
            write, ptr = lib.gsv_write_png_gray16, ctypes.c_uint16

        def nat():
            if write(str(p_nat).encode(), w, h,
                     data.ctypes.data_as(ctypes.POINTER(ptr)), 6) != 0:
                raise AssertionError(f"the native {name} encoder failed")

        times = {}
        for key, fn in (("native", nat),
                        ("PIL", lambda: Image.fromarray(data).save(p_pil))):
            fn()  # warm-up
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            times[key] = (time.perf_counter() - t0) / 3 * 1e3
        same = np.array_equal(read_image(p_nat), read_image(p_pil))
        log(f"[native] PNG {name} {w}x{h}: native {times['native']:.1f} ms "
            f"({p_nat.stat().st_size} B), PIL {times['PIL']:.1f} ms "
            f"({p_pil.stat().st_size} B), decoded equal {same}; {smi}")
        if not same:
            raise AssertionError(f"native and PIL {name} PNGs differ")


def apps_cell(chk, zero_counts, counts, no_launch, work, scene_dir, golden,
              smi):
    """The apps at full size on the 1M PLY (phase 6's): native load, the
    viewer (8-frame orbit and a DEPTH frame, FrameTimer, a trace),
    dataset_gen (4 poses, resume, disparity PNG against a direct render),
    eval on its triplets, render_all over two scene dirs, serve
    --gs-model, and compare_backends on the golden scene."""
    from gaussiansplattingviewer_tpu_torch import native
    from gaussiansplattingviewer_tpu_torch.apps import (
        dataset_gen,
        render_all,
        serve,
        viewer,
    )
    from gaussiansplattingviewer_tpu_torch.config import (
        RenderConfig,
        RenderMode,
    )
    from gaussiansplattingviewer_tpu_torch.eval import compare, metrics
    from gaussiansplattingviewer_tpu_torch.eval import reproject
    from gaussiansplattingviewer_tpu_torch.models import random_scene, save_ply
    from gaussiansplattingviewer_tpu_torch.models.ply import load_ply
    from gaussiansplattingviewer_tpu_torch.ops.render import (
        render,
        render_with_aux,
    )
    from gaussiansplattingviewer_tpu_torch.utils import colmap, profiling
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
    from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image

    t_phase = time.perf_counter()
    ply = viewer.find_ply(str(scene_dir))
    size = ["--width", FULL_W, "--height", FULL_H]

    # native PLY load, bit-equal to numpy's
    status = native.status()
    log(f"[native] host I/O path: {status}")
    t_np, (sc_np, bb_np, c_np) = host_ms(lambda: load_ply(ply,
                                                          use_native=False))
    if native.get_lib() is not None:
        t_nat, (sc_nat, bb_nat, c_nat) = host_ms(lambda: load_ply(ply))
        same = all(torch.equal(getattr(sc_nat, f), getattr(sc_np, f))
                   for f in FIELDS) and np.array_equal(bb_nat, bb_np) \
            and np.array_equal(c_nat, c_np)
        log(f"[native] 1M PLY load: native {t_nat:.1f} ms, numpy "
            f"{t_np:.1f} ms, bit-equal {same}")
        if not same:
            raise AssertionError("the native PLY load differs from numpy's")
        del sc_nat
    else:
        log(f"[native] not built: PLYs load with numpy ({t_np:.1f} ms) and "
            f"PNGs are written by PIL / numpy")

    # the viewer: an 8-frame orbit and a DEPTH frame, B1 once per frame
    secs, _ = run_app(viewer.main, ["--gs-model", scene_dir, "--orbit", 8,
                                    "--fovy", 1.0, "--out", work / "orbit",
                                    *size], zero_counts, counts, no_launch,
                      8, "viewer --orbit 8")
    frames = sorted(p.name for p in (work / "orbit").iterdir())
    first = read_image(work / "orbit" / "0.png")
    if len(frames) != 8 or first.shape != (FULL_H, FULL_W, 3) \
            or not first.std() > 1:
        raise AssertionError(f"viewer frames {frames}, {first.shape}")
    run_app(viewer.main, ["--gs-model", scene_dir, "--mode", "depth",
                          "--fovy", 1.0, "--out", work / "depth", *size],
            zero_counts, counts, no_launch, 1, "viewer --mode depth")
    depth = read_image(work / "depth" / "0.png")
    if depth.dtype != np.uint16 or depth.shape != (FULL_H, FULL_W) \
            or not depth.max() > 0:
        raise AssertionError(f"DEPTH frame {depth.dtype} {depth.shape}")
    if native.get_lib() is not None:
        png_encoders(work, first, depth, smi)

    # the viewer's frame in FrameTimer, and a short trace of it
    scene, bbox, center = viewer.load_scene(str(scene_dir))
    scene = scene.pad_to_multiple(256).to(DEVICE)
    cfg = RenderConfig(width=FULL_W, height=FULL_H)
    cam = Camera(h=FULL_H, w=FULL_W)
    cam.fovy = 1.0
    proj = cam.get_project_matrix()
    extent = float(np.linalg.norm(np.asarray(bbox[1]) - np.asarray(bbox[0])))
    eye = (np.asarray(center, np.float64) + [0.0, 0.0, extent]).astype(
        np.float32)
    view = tf.look_at(eye, center, [0, -1, 0])
    with torch.no_grad():
        def frame():
            return render(scene, view, proj, eye, cfg)

        zero_counts()
        timer = profiling.FrameTimer(frame, pixels=FULL_W * FULL_H,
                                     splats=len(scene))
        stats = timer.run(iters=5, warmup=2)
        if counts() != {**no_launch, "B1": 7}:
            raise AssertionError(f"FrameTimer launches {counts()}")
        trace_dir = Path("chiprun_out") / "chip_smoke_viewer_trace"
        with profiling.trace(str(trace_dir)) as prof:
            timer.run(iters=2, warmup=1)
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        b1_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if "tile_raster_fwd_kernel" in e.key)
        _, aux = render_with_aux(scene, view, proj, eye, cfg)
    log(f"[apps] viewer frame (FrameTimer, 5 frames): "
        f"{stats['ms_per_frame']:.3f} ms/frame, {stats['mpix_s']:.1f} Mpix/s,"
        f" {stats['msplats_s']:.1f} Msplats/s; traced 3 frames: device "
        f"{dev_us / 3e3:.3f} ms/frame, B1 {b1_us / 3e3:.3f} ms/frame "
        f"(trace in {trace_dir}); render_stats {profiling.render_stats(aux)};"
        f" orbit {secs / 8 * 1e3:.1f} ms/frame with PNG; {smi}")
    del scene

    # dataset_gen: 4 poses, B1 three times per pose; a second run resumes
    sparse = colmap_dir(scene_dir / "sparse" / "0", 4, 12.0)
    gen_argv = ["--gs-model", scene_dir, "--colmap-poses", sparse,
                "--out", work / "dataset", *size]
    secs, _ = run_app(dataset_gen.main, gen_argv, zero_counts, counts,
                      no_launch, 12, "dataset_gen (4 poses)")
    out_dir = work / "dataset" / scene_dir.name
    manifest = json.loads((out_dir / "manifest.json").read_text())
    if manifest["rendered_this_run"] != 4:
        raise AssertionError(f"dataset_gen manifest {manifest}")
    run_app(dataset_gen.main, gen_argv, zero_counts, counts, no_launch, 0,
            "dataset_gen again (resume)")
    manifest = json.loads((out_dir / "manifest.json").read_text())
    if manifest["rendered_this_run"] != 0:
        raise AssertionError(f"the resumed run rendered {manifest}")
    log(f"[apps] dataset_gen: {secs / 4 * 1e3:.1f} ms per triplet with 3 "
        f"PNGs; {smi}")

    # the disparity PNG against a direct DEPTH render of pose 0
    poses, _ = colmap.load_sparse_dir(sparse)
    view_l, _, cam_l, _ = colmap.pose_to_stereo_views(poses[0],
                                                      baseline=-0.5)
    scene = viewer.load_scene(str(scene_dir))[0].pad_to_multiple(256)
    cfg_d = RenderConfig(width=FULL_W, height=FULL_H, mode=RenderMode.DEPTH,
                         stereo_baseline=-0.5)
    with torch.no_grad():
        disp = render(scene, view_l, Camera(h=FULL_H, w=FULL_W)
                      .get_project_matrix(), cam_l, cfg_d,
                      device=DEVICE)[..., 0].cpu().numpy()
    want = np.clip(disp * 65535.0, 0, 65535).astype(np.uint16)
    d16 = read_image(out_dir / "depth" / "0.png")
    lsb = int(np.abs(d16.astype(np.int64) - want.astype(np.int64)).max())
    log(f"[apps] disparity PNG against render(DEPTH) x 65535: max "
        f"{lsb} LSB (tol 1), max disparity {int(want.max())}")
    if lsb > 1 or not want.max() > 0:
        raise AssertionError("the disparity PNG disagrees with render()")
    del scene

    # eval on the triplets: left/right PSNR and SSIM, the point cloud
    left = read_image(out_dir / "left" / "0.png")
    right = read_image(out_dir / "right" / "0.png")
    focal = Camera(h=FULL_H, w=FULL_W).get_focal()
    pts, cols = reproject.disparity_to_pointcloud(
        reproject.disparity16_to_pixels(d16, FULL_W), focal, 0.5, rgb=left,
        stride=4)
    p, s = metrics.psnr(left, right), metrics.ssim(left, right)
    log(f"[eval] triplet 0: PSNR(left, right) {p:.3f} dB, SSIM {s:.4f}; "
        f"point cloud {len(pts)} points, depth {pts[:, 2].min():.3f} .. "
        f"{pts[:, 2].max():.3f}")
    if not (np.isfinite(p) and np.isfinite(s) and len(pts) > 0
            and np.isfinite(pts).all() and cols.shape == pts.shape):
        raise AssertionError("eval on the triplets failed")

    # render_all over two scene dirs (the 1M PLY and the golden scene)
    root = work / "scenes"
    (root / "a_1m").mkdir(parents=True)
    (root / "a_1m" / "point_cloud").symlink_to(scene_dir / "point_cloud")
    gply = root / "b_golden" / "point_cloud" / "iteration_30000"
    gply.mkdir(parents=True)
    save_ply(golden, gply / "point_cloud.ply")
    colmap_dir(root / "a_1m" / "sparse" / "0", 2, 12.0)
    colmap_dir(root / "b_golden" / "sparse" / "0", 2, 9.0)
    report = work / "render_all.json"
    secs, _ = run_app(render_all.main, ["--scenes-root", root, "--out",
                                        work / "render_all", "--report",
                                        report, *size],
                      zero_counts, counts, no_launch, 12, "render_all")
    rep = json.loads(report.read_text())
    if rep != {"a_1m": "ok", "b_golden": "ok"}:
        raise AssertionError(f"render_all report {rep}")

    # serve --gs-model: one /render at 1920x1080
    args = serve.build_parser().parse_args(
        ["--gs-model", str(scene_dir), "--width", str(FULL_W), "--height",
         str(FULL_H), "--device", DEVICE])
    state = serve.build_state(args)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    zero_counts()
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/render?yaw=0.4"
                f"&pitch=0.3&mode=sh3", timeout=120) as r:
            status, body = r.status, r.read()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[apps] serve --gs-model ({len(state.scene)} splats): GET /render "
        f"-> {status}, {len(body)} B, {ms:.1f} ms, launches {counts()}")
    if status != 200 or body[:8] != b"\x89PNG\r\n\x1a\n" \
            or counts() != {**no_launch, "B1": 1}:
        raise AssertionError("serve --gs-model did not render through B1")
    del state

    # compare_backends: kernel against oracle on the flip harness's scene
    # and on the golden scene
    flip = random_scene(400, sh_degree=1, seed=17, extent=2.0,
                        mean_scale=0.06).to(DEVICE)
    eye_f = np.array([0.0, 0.0, 3.0], np.float32)
    cam3 = Camera(h=GOLDEN_H, w=GOLDEN_W)
    cam3.fovy = 1.0
    eye3 = np.array([0.5, -0.4, 6.0], np.float32)
    with torch.no_grad():
        res_f = compare.compare_backends(
            flip, tf.look_at(eye_f, [0, 0, 0], [0, -1, 0]),
            Camera(h=64, w=96).get_project_matrix(), eye_f,
            RenderConfig(width=96, height=64), ("kernel", "oracle"),
            device=DEVICE)
        res = compare.compare_backends(
            golden, tf.look_at(eye3, [0, 0, 0], [0, -1, 0]),
            cam3.get_project_matrix(), eye3,
            RenderConfig(width=GOLDEN_W, height=GOLDEN_H),
            ("kernel", "oracle"), device=DEVICE)
    kvo_f, kvo = res_f["kernel_vs_oracle"], res["kernel_vs_oracle"]
    d = np.abs(res["images"]["kernel"] - res["images"]["oracle"]).max(-1)
    log(f"[eval] compare_backends flip scene 400 splats 96x64: kernel vs "
        f"oracle {kvo_f} (tol max_abs {COMPARE_TOL})")
    log(f"[eval] compare_backends golden 10k {GOLDEN_W}x{GOLDEN_H}: kernel "
        f"vs oracle {kvo}, {int((d > COMPARE_TOL).sum())} of {d.size} "
        f"pixels above {COMPARE_TOL} (tol mean_abs "
        f"{GOLDEN_COMPARE['mean_abs']}, psnr {GOLDEN_COMPARE['psnr']} dB)")
    if not (kvo_f["max_abs"] <= COMPARE_TOL
            and kvo["mean_abs"] <= GOLDEN_COMPARE["mean_abs"]
            and kvo["psnr"] >= GOLDEN_COMPARE["psnr"]):
        raise AssertionError("kernel and oracle disagree")
    log(f"[apps] phase {time.perf_counter() - t_phase:.2f} s")


def tile_executor_cell(zero_counts, counts, no_launch, scene, view, proj,
                       eye, cfg, smi):
    """Phase 9b: the parity check (eval.gradcheck, the port of
    scripts/tpu_gradcheck.py) on the card, the kernel route against the
    tile executor: the toy case (B1, B2, B3 once each) and the bench-scale
    fused case (B1, B2, B4 and B5), each within tpu_gradcheck.py's
    thresholds; then the 1M bench scene at full size served once and
    trained one step (bench.py's step) through backend="tile", launching
    no kernel: the frame against the kernel route's within the parity
    check's forward tolerance, the step's loss and gradients finite, the
    plain executor's frame and step ms (read, not gated) and its chunk
    steps beside the card."""
    from gaussiansplattingviewer_tpu_torch.eval import gradcheck
    from gaussiansplattingviewer_tpu_torch.models import GaussianData
    from gaussiansplattingviewer_tpu_torch.ops import blend
    from gaussiansplattingviewer_tpu_torch.ops.render import render

    t_phase = time.perf_counter()
    # the kernel route's launches: a frame (B1; fused, B1 and B4) and a
    # gradient (B2, B3; fused, B2, B4 and B5 twice)
    for name, case, need in (
            ("toy", gradcheck.TOY, {**no_launch, "B1": 1, "B2": 1, "B3": 1}),
            ("bench scale", gradcheck.BENCH_SCALE,
             {**no_launch, "B1": 1, "B2": 1, "B4": 2, "B5": 2})):
        zero_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = gradcheck.run_case(**case, device=DEVICE)
        seconds = time.perf_counter() - t0
        got = counts()
        for line in printed.getvalue().splitlines():
            log(f"[parity] {line}")
        worst = {k: max(f[k] for f in res["fields"].values())
                 for k in ("rel_max", "rel_p99")}
        log(f"[parity] {name} ({res['config']}): pass {res['pass']}, fwd "
            f"max|diff| {res['fwd_max_abs_diff']:.3e}, worst rel_max "
            f"{worst['rel_max']:.3e}, worst rel_p99 {worst['rel_p99']:.3e} "
            f"(thresholds {res['thresholds']}), {seconds:.2f} s, kernel "
            f"route launches {got}; {smi}")
        if got != need:
            raise AssertionError(f"parity {name}: launched {got}")
        if not res["pass"]:
            raise AssertionError(f"parity {name}: the kernels and the tile "
                                 f"executor disagree")

    # the 1M frame and step through the tile executor, its chunk steps
    # counted around ops/blend.py's traversal
    steps = []
    traverse = blend._chunk_steps

    def counted(*a, **k):
        n = 0
        for item in traverse(*a, **k):
            n += 1
            yield item
        steps.append(n)

    sc = GaussianData(*(getattr(scene, f).detach().clone()
                        .requires_grad_(True) for f in FIELDS))
    params = [getattr(sc, f) for f in FIELDS]
    with torch.no_grad():
        ref = render(sc, view, proj, eye, cfg)
    blend._chunk_steps = counted
    zero_counts()
    try:
        with torch.no_grad():
            ms_frame, img = host_ms(lambda: render(sc, view, proj, eye, cfg,
                                                   backend="tile"))
        ms_step, (loss, aux) = host_ms(lambda: sgd_step(
            sc, params, view, proj, eye, cfg, backend="tile"))
    finally:
        blend._chunk_steps = traverse
    got = counts()
    loss = float(loss.detach())
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in params)
    diff = float((img - ref).abs().max())
    log(f"[tile] {len(scene)} splats SH{scene.sh_degree} {cfg.width}x"
        f"{cfg.height} through backend=\"tile\" "
        f"(the tile executor, plain PyTorch): frame {ms_frame:.3f} ms, "
        f"training step {ms_step:.3f} ms (read, not gated); chunk steps: "
        f"frame {steps[0]}, step forward {steps[1]} and backward "
        f"{steps[2]}; {int(aux['num_duplicates'])} rows listed; loss "
        f"{loss:.6g}; max|frame - kernel frame| {diff:.3e} (tol "
        f"{gradcheck.BS_FWD_TOL}); kernel launches {got}; {smi}")
    img_np = img.cpu().numpy()
    if got != no_launch:
        raise AssertionError(f"the tile executor launched {got}")
    if img_np.shape != (cfg.height, cfg.width, 3) \
            or not np.isfinite(img_np).all() or not img_np.std() > 0.01:
        raise AssertionError("the tile executor's frame is not a finite "
                             "non-blank (H, W, 3) image")
    if not (diff < gradcheck.BS_FWD_TOL and np.isfinite(loss)
            and grads_finite):
        raise AssertionError("the tile executor's frame or step is wrong")
    log(f"[tile] phase {time.perf_counter() - t_phase:.2f} s")


# the bench JSON line's keys: bench.py's and the port's four
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "fwd_mpix_s",
              "fwd_vs_baseline", "garden_ms_frame", "garden_mpix_s",
              "parity_pass", "card", "ms_step", "device_ms_step", "busy")
# kernel wrapper launches per profiled step: the 1M step is classic, the
# garden step fused (the tuner's decisions), the forward B1 alone
BENCH_LAUNCHES = {
    "headline": {"B1": 0, "B2": 1, "B3": 1, "B4": 0, "B5": 0},
    "forward": {"B1": 1, "B2": 0, "B3": 0, "B4": 0, "B5": 0},
    "garden": {"B1": 0, "B2": 1, "B3": 0, "B4": 1, "B5": 2}}
MODULE_TIMEOUT_S = 900


def run_module(module, smi, *argv):
    """``python -m gaussiansplattingviewer_tpu_torch.<module>`` from the
    repository's root, as a user runs it; fails on a non-zero exit.
    Returns (stdout, stderr)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"gaussiansplattingviewer_tpu_torch.{module}",
         *argv], cwd=root, env=env, capture_output=True, text=True,
        timeout=MODULE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-60:]:
        log(f"[{module}] {line}")
    for line in proc.stdout.splitlines()[-40:]:
        log(f"[{module}] {line}")
    log(f"[modules] {module}: rc {proc.returncode} in {seconds:.1f} s; {smi}")
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr


def modules_cell(smi):
    """Phase 10: the JAX repository's measurement entry points as the
    port's modules, each a subprocess from the repository's root: bench
    with its defaults (the 1M training step, the forward, the garden step
    and the parity check), its JSON line's keys, parity_pass true and the
    profiled steps' launches; eval.ply_roundtrip at 5.8M splats passing
    every gate; eval.scaling's rows, N shard times each, efficiencies in
    (0, 1.05], the bands of rows that dropped no splat against render()
    and no bandwidth constant."""
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig

    t_phase = time.perf_counter()
    out, err = run_module("bench", smi)
    result = json.loads(out.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in result]
    if missing or result["parity_pass"] is not True:
        raise AssertionError(f"bench's line lacks {missing} or parity "
                             f"failed: {result}")
    profiled = {}
    for line in err.splitlines():
        if line.startswith("# profiled: "):
            d = json.loads(line[len("# profiled: "):])
            profiled[d["label"]] = d
    for label, want in BENCH_LAUNCHES.items():
        got = profiled[label]["launches_per_step"]
        if got != want:
            raise AssertionError(f"bench {label}: launches per step {got}")
    if not all(0 < result[k] for k in ("value", "fwd_mpix_s",
                                        "garden_mpix_s", "ms_step",
                                        "device_ms_step", "busy")):
        raise AssertionError(f"bench's numbers are not positive: {result}")

    run_module("eval.ply_roundtrip", smi)
    ply = json.loads((Path(__file__).resolve().parent / "chiprun_out"
                      / "ply_roundtrip_cuda.json").read_text())
    if ply["pass"] is not True:
        raise AssertionError(f"ply_roundtrip failed its gates: {ply}")

    run_module("eval.scaling", smi)
    path = Path(__file__).resolve().parent / "chiprun_out" / \
        "scaling_cuda.json"
    text = path.read_text()
    scaling = json.loads(text)
    if scaling["config"]["render_truncated"] != 0:
        raise AssertionError(f"scaling's frame truncated rows: "
                             f"{scaling['config']}")
    stop = RenderConfig().early_stop_transmittance
    tol = stop * max(1.0, scaling["config"]["render_max_abs"])
    # JAX's band budgets drop splats where a band holds more than its
    # share allows (counted in ``dropped``): those bands render another
    # image; every other row's bands agree with render()
    for row in scaling["runs"]:
        ok = (len(row["shard_ms"]) == row["n_dev"]
              and all(t > 0 for t in row["shard_ms"])
              and 0 < row["scaling_eff"] <= 1.05
              and 0 < row["balance_eff"] <= 1.05
              and (row["dropped"] > 0 or row["max_abs_vs_render"] <= tol))
        if not ok:
            raise AssertionError(f"scaling row out of bounds (bands vs "
                                 f"render tol {tol:.1e}): {row}")
    exact = [(r["n_dev"], r["assignment"]) for r in scaling["runs"]
             if r["dropped"] == 0]
    log(f"[modules] scaling rows that dropped no splat (held to render() "
        f"within {tol:.1e}): {exact}")
    if not {(1, "contiguous"), (2, "contiguous")} <= set(exact):
        raise AssertionError("scaling: the 1- and 2-band rows dropped "
                             "splats")
    if "gbps" in text.lower():
        raise AssertionError("scaling's JSON carries a bandwidth constant")
    log(f"[modules] phase {time.perf_counter() - t_phase:.2f} s")


def bound(name, flops, nbytes):
    """(bound ms, what bounds it) from the work this run's data needs."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"[bound] {name}: {flops:.4g} FLOP, {nbytes:.4g} B -> "
        f"{max(ops_ms, bytes_ms):.4f} ms by {by} (ops {ops_ms:.4f} ms, "
        f"bytes {bytes_ms:.4f} ms)")
    return max(ops_ms, bytes_ms), by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from gaussiansplattingviewer_tpu_torch.apps import serve, train
    from gaussiansplattingviewer_tpu_torch.config import (
        RenderConfig,
        RenderMode,
    )
    from gaussiansplattingviewer_tpu_torch.models import (
        random_scene,
        save_ply,
    )
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.render import (
        render,
        render_with_aux,
    )
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    t_start = time.perf_counter()
    # files of the run (PLYs, frames, datasets), removed at exit
    work_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    work = Path(work_dir.name)
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"B1": b1.tile_raster_fwd, "B2": b1.tile_raster_fwd_train,
                "B3": b3.tile_raster_bwd, "B4": b1.tile_raster_fwd_seeded,
                "B5": b3.tile_raster_bwd_fused}
    no_launch = {k: 0 for k in counters}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # ---- 1. card identity
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {card}, devices {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build (all sources at once)
    kernels = ["tile_raster_fwd", "tile_raster_bwd"]
    t0 = time.perf_counter()
    built = build.build(kernels)
    log(f"[build] {len(built)} of {len(kernels)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "ptxas" in line:
                log(f"[build]   {line.strip()}")
    for name in kernels:
        build.load(name)
    occupancy = {
        "B1": lambda m: b1.kernel_occupancy(m),
        "B2": lambda m: b1.kernel_occupancy(m, train=True),
        "B4": lambda m: b1.kernel_occupancy(m, seeded=True),
        "B4 train": lambda m: b1.kernel_occupancy(m, train=True,
                                                  seeded=True),
        "B3": lambda m: b3.kernel_occupancy(m, False),
        "B5": lambda m: b3.kernel_occupancy(m, True),
        **{f"{k} tile {ts}": (lambda m, ts=ts, train=train, seeded=seeded:
                              b1.kernel_occupancy(m, train=train,
                                                  seeded=seeded,
                                                  tile_size=ts))
           for ts in TILE_SIZES for k, train, seeded in (
               ("B1", False, False), ("B2", True, False),
               ("B4", False, True))},
        **{f"B3 tile {ts}": (lambda m, ts=ts:
                             b3.kernel_occupancy(m, False, ts))
           for ts in TILE_SIZES}}
    for key, query in occupancy.items():
        for mode in (RenderMode.SH3, RenderMode.BILLBOARD,
                     RenderMode.FLAT_BALL, RenderMode.GAUSSIAN_BALL):
            occ = query(mode)
            log(f"[build] {key} {mode.name}: {occ['registers']} registers, "
                f"{occ['local_bytes']} B spilled, {occ['smem_bytes']} B "
                f"shared per CTA, {occ['ctas_per_sm']} CTAs per SM")

    chk = Checks()

    # ---- 3. kernels vs plain on the golden scene, every mode
    cam3 = Camera(h=GOLDEN_H, w=GOLDEN_W)
    cam3.fovy = 1.0
    eye3 = np.array([0.5, -0.4, 6.0], np.float32)
    view3 = tf.look_at(eye3, [0, 0, 0], [0, -1, 0])
    proj3 = cam3.get_project_matrix()
    scene3 = random_scene(GOLDEN_SPLATS, sh_degree=3, seed=5, extent=3.0,
                          mean_scale=0.04, anisotropy=0.7
                          ).pad_to_multiple(1024).to(dev)

    def binned(scene, cfg, **band):
        splats = project(scene, view3, proj3, eye3, cfg)
        return binning.bin_splats(splats, cfg, **band)

    def splats_of(scene, cfg):
        return project(scene, view3, proj3, eye3, cfg)

    for name in GOLDEN_MODES:
        cfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H,
                           mode=RenderMode[name])
        kernels_vs_plain(chk, f"10k {name}", binned(scene3, cfg), cfg)
        rows2 = fused_vs_plain(chk, f"10k {name}", splats_of(scene3, cfg),
                               cfg.with_(**GOLDEN_FUSED))
        log(f"[check] 10k {name}: residual pass blended {rows2} rows")
        if rows2 == 0 and int(cfg.mode) >= int(RenderMode.DEPTH):
            raise AssertionError(f"{name}: the residual pass had no work")
        img = render(scene3, view3, proj3, eye3, cfg)
        golden = np.load(GOLDEN_DIR / f"refres10k_{int(cfg.mode)}.npz")[
            "img"].astype(np.float32)
        diff = float(np.abs(img.cpu().numpy() - golden).max())
        atol = 2e-3 * max(1.0, float(np.abs(golden).max()))
        log(f"[golden] 10k {name}: max|img - golden| {diff:.3e} "
            f"(budget {atol:.1e})")
        if not diff <= atol:
            raise AssertionError(f"{name} render disagrees with its golden")

    opaque = random_scene(GOLDEN_SPLATS, sh_degree=3, seed=5, extent=3.0,
                          mean_scale=0.08, anisotropy=0.7)
    opaque.opacity.fill_(0.99)
    cfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H)
    opaque = opaque.pad_to_multiple(1024).to(dev)
    bs = binned(opaque, cfg)
    nproc = kernels_vs_plain(chk, "10k opaque", bs, cfg)
    fused_vs_plain(chk, "10k opaque", splats_of(opaque, cfg),
                   cfg.with_(**GOLDEN_FUSED))
    stopped = int((rows_blended(bs.tile_starts, nproc)
                   < bs.tile_counts).sum())
    log(f"[check] 10k opaque: early stop fired in {stopped} tiles")
    if stopped == 0:
        raise AssertionError("the opaque scene never stopped early")

    # an interleaved shard: global tile rows 1, 3, 5, ...
    band_rows = cfg.tiles_y // 2
    bs = binned(scene3, cfg, row_offset=1, local_rows=band_rows, row_stride=2)
    kernels_vs_plain(chk, "10k band (rows 1::2)", bs, cfg, 1, (band_rows, 2))
    fused_vs_plain(chk, "10k band (rows 1::2)", splats_of(scene3, cfg),
                   cfg.with_(**GOLDEN_FUSED), 1, band_rows, 2)

    # ---- 3b. tile sizes 8 and 32 (B1, B2, B3, B4 inference) on the golden
    # scene
    for ts in TILE_SIZES:
        rows2 = 0
        for name in GOLDEN_MODES:
            cfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H,
                               mode=RenderMode[name], tile_size=ts)
            rows2 += tile_kernels_vs_plain(chk, f"10k tile {ts} {name}",
                                           splats_of(scene3, cfg),
                                           binned(scene3, cfg), cfg)
        cfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H, tile_size=ts)
        tile_kernels_vs_plain(chk, f"10k tile {ts} opaque",
                              splats_of(opaque, cfg), binned(opaque, cfg),
                              cfg)
        band_rows = cfg.tiles_y // 2
        tile_kernels_vs_plain(
            chk, f"10k tile {ts} band (rows 1::2)", splats_of(scene3, cfg),
            binned(scene3, cfg, row_offset=1, local_rows=band_rows,
                   row_stride=2), cfg, 1, band_rows, 2)
        log(f"[tiles] 10k tile {ts}: residual passes listed {rows2} rows "
            f"over the 7 modes")
        if rows2 == 0:
            raise AssertionError(f"tile {ts}: the residual pass had no work")
    training_tiles_refused(counts)
    del opaque

    # ---- 4. the serving path at full size
    cfg4 = RenderConfig(width=FULL_W, height=FULL_H)
    cam4 = Camera(h=FULL_H, w=FULL_W)
    cam4.fovy = 1.0
    eye4 = np.array([0.0, 0.0, 9.0], np.float32)
    view4 = tf.look_at(eye4, [0, 0, 0], [0, -1, 0])
    proj4 = cam4.get_project_matrix()
    t0 = time.perf_counter()
    scene_1m = random_scene(FULL_SPLATS, sh_degree=3, seed=0, extent=4.0,
                            mean_scale=0.015)
    big = scene_1m.pad_to_multiple(1024).to(dev)
    log(f"[full] scene of {len(big)} splats made in "
        f"{time.perf_counter() - t0:.2f} s")

    with torch.no_grad():
        for _ in range(2):  # warm-up
            render(big, view4, proj4, eye4, cfg4)
        torch.cuda.synchronize()
        ms_proj, splats = cuda_ms(
            lambda: project(big, view4, proj4, eye4, cfg4), 3)
        ms_bin, bs = cuda_ms(lambda: binning.bin_splats(splats, cfg4), 3)
    blend_args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg4)
    ms_b1, (rgb, trans) = cuda_ms(lambda: b1.tile_raster_fwd(*blend_args), 10)
    px, py = b1.tile_pixel_grid(cfg4, cfg4.tiles_y, device=dev)
    ms_b1_plain, (prgb, ptrans, nproc) = host_ms(lambda: b1.blend_tiles_plain(
        bs.table, bs.tile_starts[:-1], bs.tile_counts, px, py, cfg4))
    chk.close("B1", "1M 1080p full frame B1 rgb", rgb, prgb)
    chk.close("B1", "1M 1080p full frame B1 T", trans, ptrans)
    gen = torch.Generator(device="cpu").manual_seed(0)
    sample = torch.randperm(cfg4.num_tiles, generator=gen)[:256].to(dev)
    srgb, strans, _ = b1.blend_tiles_plain(
        bs.table, bs.tile_starts[:-1][sample], bs.tile_counts[sample],
        px[sample], py[sample], cfg4)
    chk.close("B1", "1M 1080p 256 sampled tiles B1 rgb", rgb[sample], srgb)
    chk.close("B1", "1M 1080p 256 sampled tiles B1 T", trans[sample], strans)

    # the work this run's data needs: the fragments in the rects of the
    # rows each tile actually blended
    ntile = cfg4.num_tiles
    rows, frags = needed("B1", bs.table, bs.tile_starts, bs.tile_counts,
                         nproc, cfg4)
    log(f"[full] blend rows {int(bs.tile_counts.sum())} listed, {rows} "
        f"blended before the early stop")
    seg_bytes = (2 * ntile + 1) * 4
    bound_b1 = bound("B1", frags * FLOPS_PER_FRAGMENT,
                     rows * BLEND_ATTR_BYTES + ntile * 256 * 4 * 4
                     + seg_bytes)

    # the serving path: counts at 0, three frames through render(), read
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    with torch.no_grad():
        for _ in range(3):
            ms, (img, aux) = host_ms(
                lambda: render_with_aux(big, view4, proj4, eye4, cfg4))
            frame_ms.append(ms)
    serve_counts = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_frame = float(np.mean(frame_ms))
    log(f"[full] 1M SH3 {FULL_W}x{FULL_H} frames "
        f"{[f'{m:.3f}' for m in frame_ms]} ms -> {ms_frame:.3f} ms/frame, "
        f"{FULL_W * FULL_H / ms_frame / 1e3:.3f} Mpix/s")
    log(f"[full] stages (CUDA events): project {ms_proj:.3f} ms, bin "
        f"{ms_bin:.3f} ms, B1 {ms_b1:.3f} ms, B1 plain {ms_b1_plain:.3f} ms")
    log(f"[full] num_duplicates {int(aux['num_duplicates'])}, truncated "
        f"{int(aux['truncated'])}, overflow {int(aux['overflow'])}, peak "
        f"memory {peak_gib:.3f} GiB, launches {serve_counts}")
    if serve_counts != {**no_launch, "B1": 3}:
        raise AssertionError(f"3 frames launched {serve_counts}")
    img_np = img.cpu().numpy()
    if img_np.shape != (FULL_H, FULL_W, 3) or not np.isfinite(img_np).all():
        raise AssertionError("full-size image is not finite (H, W, 3)")
    if not (img_np.mean() > 0.01 and img_np.std() > 0.01):
        raise AssertionError("full-size image is blank")
    del splats, bs, rgb, trans, prgb, ptrans, srgb, strans

    # ---- 4b. the serving path at tile sizes 8 and 32 (16 is phase 4's),
    # and the fused serving path at 8, 16 and 32
    tiles = {ts: served_at_tile(chk, zero_counts, counts, no_launch, big,
                                view4, proj4, eye4,
                                cfg4.with_(tile_size=ts), smi)
             for ts in TILE_SIZES}
    tiles[16] = {"img": img}
    for ts in (8, 16, 32):
        tiles[ts].update(fused_served_at_tile(
            chk, zero_counts, counts, no_launch, big, view4, proj4, eye4,
            cfg4.with_(tile_size=ts), tiles[ts].pop("img"), smi))

    # ---- 5. the training step at full size
    trained = {16: trained_at_tile(chk, zero_counts, counts, no_launch, big,
                                   view4, proj4, eye4, cfg4, smi,
                                   profile=True)}

    # ---- 5b. the training step at tile sizes 8 and 32 (classic)
    for ts in TILE_SIZES:
        trained[ts] = trained_at_tile(chk, zero_counts, counts, no_launch,
                                      big, view4, proj4, eye4,
                                      cfg4.with_(tile_size=ts), smi)

    # ---- 6. the trainer through its CLI, on the 1M scene as a scene dir
    scene_dir = work / "scene_1m"
    ply = scene_dir / "point_cloud" / "iteration_30000" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    t0 = time.perf_counter()
    save_ply(scene_1m, ply)
    log(f"[trainer] {FULL_SPLATS} splats written to a PLY in "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--gs-model", str(scene_dir), "--self-distill",
                         "--steps", "3", "--width", str(FULL_W),
                         "--height", str(FULL_H), "--log-every", "1",
                         "--out", str(work / "trained.npz")])
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    trainer_counts = counts()
    for line in out.getvalue().splitlines():
        log(f"[trainer] {line}")
    log(f"[trainer] rc {rc} in {trainer_s:.2f} s, launches "
        f"{trainer_counts}")
    if rc != 0 or "final_psnr_db" not in out.getvalue():
        raise AssertionError("the trainer CLI failed")
    if trainer_counts["B2"] != 3 or trainer_counts["B3"] != 3:
        raise AssertionError("the trainer's steps missed B2/B3")

    # ---- 7. the serve app
    args = serve.build_parser().parse_args(
        ["--random-scene", str(FULL_SPLATS), "--width", str(SERVE_W),
         "--height", str(SERVE_H), "--device", DEVICE])
    state = serve.build_state(args)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    zero_counts()
    try:
        for path in ("/info",
                     "/render?yaw=0.4&pitch=0.3&mode=sh3",
                     "/render?yaw=1.2&pitch=-0.2&mode=gaussian-ball-soft",
                     "/render?fly=1&px=0&py=0&pz=9&yaw=3.14159&pitch=0"):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=120) as r:
                status, body = r.status, r.read()
            ms = (time.perf_counter() - t0) * 1e3
            ok = status == 200 and (
                path == "/info" or body[:8] == b"\x89PNG\r\n\x1a\n")
            log(f"[serve] GET {path} -> {status}, {len(body)} B, {ms:.1f} ms")
            if not ok:
                raise AssertionError(f"bad response to {path}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    app_counts = counts()
    log(f"[serve] launches for 3 renders: {app_counts}")
    if app_counts != {**no_launch, "B1": 3}:
        raise AssertionError("serve renders did not go through B1 alone")

    # ---- 8. the sharded cell
    sharded_cell(chk, zero_counts, counts, no_launch, big, view4, proj4, eye4,
                 cfg4)

    del big
    torch.cuda.empty_cache()

    # ---- 8b. the apps, eval and native I/O at full size
    apps_cell(chk, zero_counts, counts, no_launch, work, scene_dir, scene3,
              smi)
    del scene3
    torch.cuda.empty_cache()

    # ---- 9. the garden cell
    g = garden_cell(chk, zero_counts, counts, no_launch)

    # ---- 9b. the tile executor: the parity check, the 1M frame and step
    big = scene_1m.pad_to_multiple(1024).to(dev)
    del scene_1m
    tile_executor_cell(zero_counts, counts, no_launch, big, view4, proj4,
                       eye4, cfg4, smi)
    del big
    torch.cuda.empty_cache()

    # ---- 10. the measurement entry points: bench, ply_roundtrip, scaling
    modules_cell(smi)

    # ---- 11. kernels line, card line, result
    fwd_src = "gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu"
    bwd_src = "gaussiansplattingviewer_tpu_torch/csrc/tile_raster_bwd.cu"
    pallas = "gaussiansplattingviewer_tpu/ops/pallas/"

    def entry(name, src, replaces, key, launches, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": pallas + replaces, "launches": launches,
                "max_abs_err": chk.err[key], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    # B2 and B3 at a tile size, from phase 5 or 5b
    def train_entries(ts):
        t, sfx = trained[ts], "" if ts == 16 else f" (tile {ts})"
        key = "" if ts == 16 else f" t{ts}"
        return [
            entry(f"tile_raster_fwd_train{sfx}", fwd_src,
                  "tile_raster_fwd.py:418", f"B2{key}", t["counts"]["B2"],
                  t["ms_b2"], t["ms_b2_plain"], t["bound_b2"]),
            entry(f"tile_raster_bwd{sfx}", bwd_src, "tile_raster_bwd.py:614",
                  f"B3{key}", t["counts"]["B3"], t["ms_b3"],
                  t["ms_b3_plain"], t["bound_b3"])]

    # B1 and B4 (inference) from phase 4b, B2 and B3 from 5b, at the other
    # tile sizes
    per_tile = []
    for ts in TILE_SIZES:
        t = tiles[ts]
        per_tile += train_entries(ts) + [
            entry(f"tile_raster_fwd (tile {ts})", fwd_src,
                  "tile_raster_fwd.py:202", f"B1 t{ts}", t["launches"],
                  t["ms"], t["plain_ms"], t["bound"]),
            entry(f"tile_raster_fwd_seeded (tile {ts}, inference)", fwd_src,
                  "tile_raster_fwd.py:437", f"B4 t{ts}", t["b4_launches"],
                  t["b4_ms"], t["b4_plain_ms"], t["b4_bound"])]

    line = {"kernels": [
        entry("tile_raster_fwd", fwd_src, "tile_raster_fwd.py:202", "B1",
              serve_counts["B1"], ms_b1, ms_b1_plain, bound_b1),
        *train_entries(16),
        entry("tile_raster_fwd_seeded", fwd_src, "tile_raster_fwd.py:437",
              "B4", g["counts"]["B4"], g["ms_b4"], g["ms_b4_plain"],
              g["bound_b4"]),
        entry("tile_raster_bwd_fused", bwd_src, "tile_raster_bwd.py:536",
              "B5", g["counts"]["B5"], g["ms_b5"], g["ms_b5_plain"],
              g["bound_b5"]),
        *per_tile,
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    work_dir.cleanup()
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
