#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaussiansplattingviewer_tpu_torch)
on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from csrc/ (one nvcc per source, started
     together) and print nvcc's -Xptxas -v report;
  3. every kernel (B1 inference forward, B2 train forward, B3 blend
     backward) against its plain PyTorch version on the 10k-splat golden
     scene at 1160x522: all 7 modes, an opaque early-stop scene and an
     interleaved shard; the rendered images against the stored goldens
     (tests/goldens);
  4. the serving path at full size: the 1M-splat SH-3 bench scene at
     1920x1080 through render() under no_grad, with CUDA-event stage times
     and B1 held against its plain version on the same table;
  5. the training step at full size (the JAX bench.py default step: loss
     sum(img^2), SGD at lr 1e-12): CUDA-event stage times inside real
     steps, B2 and B3 timed alone and held against their plain versions on
     a step's own table, the device's busy share (torch.profiler), 5 timed
     steps through render() + backward(), their launch counts and
     gradients;
  6. the trainer through its CLI (apps.train.main, 3 self-distill steps at
     1920x1080 from the 1M scene written as a PLY);
  7. the serve app on 127.0.0.1 answering /info and three /render requests;
  8. a JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import contextlib
import io
import json
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

GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "goldens"
GOLDEN_MODES = ("SH1", "SH2", "SH3", "DEPTH", "BILLBOARD", "FLAT_BALL",
                "GAUSSIAN_BALL")
FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
DEVICE = "cuda"
# the full cell: the JAX bench.py default scene and resolution
FULL_SPLATS, FULL_W, FULL_H = 1_000_000, 1920, 1080
GOLDEN_W, GOLDEN_H, GOLDEN_SPLATS = 1160, 522, 10_000
SERVE_W, SERVE_H = 960, 540
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
        self.err = {"B1": 0.0, "B2": 0.0, "B3": 0.0}

    def _record(self, kernel, tag, err, tol):
        self.err[kernel] = max(self.err[kernel], err)
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
        """Per table column within 1e-5 * max|plain column|: B3 and its
        plain version share t_i and alpha bit for bit, and differ only in
        the order of each row's sum over 256 pixels and of the suffix."""
        worst, err = 0.0, 0.0
        for c in range(got.shape[0]):
            e = float((got[c] - want[c]).abs().max())
            scale = float(want[c].abs().max())
            err = max(err, e)
            if e > 0:
                worst = max(worst, e / scale if scale > 0 else float("inf"))
        log(f"[check] {tag}: max|diff| {err:.3e}, worst column "
            f"|diff|/max|plain| {worst:.3e} (tol 1.0e-05)")
        self.err[kernel] = max(self.err[kernel], err)
        if not worst <= 1e-5:
            raise AssertionError(f"{tag}: kernel disagrees with plain")


def seeded_cotangents(trans, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g_rgb = torch.randn((*trans.shape, 3), generator=gen)
    g_trans = torch.randn(tuple(trans.shape), generator=gen)
    return g_rgb.to(trans.device), g_trans.to(trans.device)


def kernels_vs_plain(chk, tag, bs, cfg, row_offset=0, band=()):
    """B1, B2 and B3 against their plain versions on one binned table;
    returns B2's nproc."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )

    args = (bs.table, bs.tile_starts, bs.tile_counts, row_offset, cfg, *band)
    rgb, trans = b1.tile_raster_fwd(*args)
    torch.cuda.synchronize()
    prgb, ptrans = b1.tile_raster_fwd_plain(*args)
    chk.close("B1", f"{tag} B1 rgb", rgb, prgb)
    chk.close("B1", f"{tag} B1 T", trans, ptrans)

    rgb, trans, ckpt, nproc = b1.tile_raster_fwd_train(*args)
    torch.cuda.synchronize()
    prgb, ptrans, pckpt, pnproc = b1.tile_raster_fwd_train_plain(*args)
    chk.close("B2", f"{tag} B2 rgb", rgb, prgb)
    chk.close("B2", f"{tag} B2 T", trans, ptrans)
    chk.equal("B2", f"{tag} B2 nproc", nproc, pnproc)
    chk.equal("B2", f"{tag} B2 ckpt", ckpt, pckpt)

    g_rgb, g_trans = seeded_cotangents(trans, seed=7)
    bwd = (bs.table, bs.tile_starts, bs.tile_counts, nproc, ckpt, row_offset,
           g_rgb, g_trans, trans, cfg, *band)
    g = b3.tile_raster_bwd(*bwd)
    torch.cuda.synchronize()
    chk.columns("B3", f"{tag} B3 g_table", g, b3.tile_raster_bwd_plain(*bwd))
    if not float(g.abs().max()) > 0:
        raise AssertionError(f"{tag}: B3 gave a zero gradient")
    return nproc


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
        GaussianData,
        random_scene,
        save_ply,
    )
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_bwd as b3,
    )
    from gaussiansplattingviewer_tpu_torch.ops.kernels import (
        tile_raster_fwd as b1,
    )
    from gaussiansplattingviewer_tpu_torch.ops.projection import project
    from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import (
        _tiles_to_image,
    )
    from gaussiansplattingviewer_tpu_torch.ops.render import (
        render,
        render_with_aux,
    )
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"B1": b1.tile_raster_fwd, "B2": b1.tile_raster_fwd_train,
                "B3": b3.tile_raster_bwd}

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

    for name in GOLDEN_MODES:
        cfg = RenderConfig(width=GOLDEN_W, height=GOLDEN_H,
                           mode=RenderMode[name])
        kernels_vs_plain(chk, f"10k {name}", binned(scene3, cfg), cfg)
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
    bs = binned(opaque.pad_to_multiple(1024).to(dev), cfg)
    nproc = kernels_vs_plain(chk, "10k opaque", bs, cfg)
    stopped = int((rows_blended(bs.tile_starts, nproc)
                   < bs.tile_counts).sum())
    log(f"[check] 10k opaque: early stop fired in {stopped} tiles")
    if stopped == 0:
        raise AssertionError("the opaque scene never stopped early")

    # an interleaved shard: global tile rows 1, 3, 5, ...
    band_rows = cfg.tiles_y // 2
    bs = binned(scene3, cfg, row_offset=1, local_rows=band_rows, row_stride=2)
    kernels_vs_plain(chk, "10k band (rows 1::2)", bs, cfg, 1, (band_rows, 2))

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

    # the work this run's data needs: the rows each tile actually blended
    ntile = cfg4.num_tiles
    rows = int(rows_blended(bs.tile_starts, nproc).sum())
    log(f"[full] blend rows {int(bs.tile_counts.sum())} listed, {rows} "
        f"blended before the early stop")
    seg_bytes = (2 * ntile + 1) * 4
    bound_b1 = bound("B1", rows * 256 * FLOPS_PER_FRAGMENT,
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
    if serve_counts != {"B1": 3, "B2": 0, "B3": 0}:
        raise AssertionError(f"3 frames launched {serve_counts}")
    img_np = img.cpu().numpy()
    if img_np.shape != (FULL_H, FULL_W, 3) or not np.isfinite(img_np).all():
        raise AssertionError("full-size image is not finite (H, W, 3)")
    if not (img_np.mean() > 0.01 and img_np.std() > 0.01):
        raise AssertionError("full-size image is blank")
    del splats, bs, rgb, trans, prgb, ptrans, srgb, strans

    # ---- 5. the training step at full size
    sc = GaussianData(*(getattr(big, f).detach().clone().requires_grad_(True)
                        for f in FIELDS))
    params = [getattr(sc, f) for f in FIELDS]

    def train_step():
        for p in params:
            p.grad = None
        img = render(sc, view4, proj4, eye4, cfg4)
        loss = (img * img).sum()
        loss.backward()
        with torch.no_grad():
            for p in params:
                p.sub_(p.grad, alpha=SGD_LR)
        return loss

    for _ in range(2):  # warm-up
        train_step()
    torch.cuda.synchronize()

    # stage times inside real steps: CUDA events recorded between the
    # forward stages and, from autograd hooks, when the table's gradient
    # (after B3) and the packed rows' gradient (after the fold) are ready
    stages = ("project", "bin", "B2", "image+loss", "B3", "fold",
              "projection backward", "update")

    def staged_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        for p in params:
            p.grad = None
        ev[0].record()
        splats = project(sc, view4, proj4, eye4, cfg4)
        ev[1].record()
        bs = binning.bin_splats(splats, cfg4)
        ev[2].record()
        rgb, trans = blend_tiles(cfg4, cfg4.tiles_y, 1, bs.table,
                                 bs.tile_starts, bs.tile_counts, 0)
        ev[3].record()
        img, t_img = _tiles_to_image(rgb, trans, cfg4)
        img = img + cfg4.background * t_img[..., None]
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

    staged = np.array([staged_step() for _ in range(3)])
    stage_ms = dict(zip(stages, staged.mean(axis=0).tolist()))
    log("[train] stages in a step (CUDA events, mean of 3): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stage_ms.items())
        + f"; sum {staged.sum(axis=1).mean():.3f} ms")

    # the kernels alone on one step's own table and cotangents
    splats = project(sc, view4, proj4, eye4, cfg4)
    bs = binning.bin_splats(splats, cfg4)
    targs = (bs.table.detach(), bs.tile_starts, bs.tile_counts, 0, cfg4)
    with torch.no_grad():
        ms_b2, (rgb, trans, ckpt, nproc) = cuda_ms(
            lambda: b1.tile_raster_fwd_train(*targs), 10)
    # the cotangents the step's backward hands B3: d sum(img^2) / d tiles
    rgb_l = rgb.detach().requires_grad_(True)
    trans_l = trans.detach().requires_grad_(True)
    img_l, t_l = _tiles_to_image(rgb_l, trans_l, cfg4)
    img_l = img_l + cfg4.background * t_l[..., None]
    g_rgb, g_trans = torch.autograd.grad((img_l * img_l).sum(),
                                         (rgb_l, trans_l))
    bwd = (targs[0], bs.tile_starts, bs.tile_counts, nproc, ckpt, 0,
           g_rgb.contiguous(), g_trans.contiguous(), trans, cfg4)
    ms_b3, g_table = cuda_ms(lambda: b3.tile_raster_bwd(*bwd), 5)
    log(f"[train] kernels alone (CUDA events): B2 {ms_b2:.3f} ms, B3 "
        f"{ms_b3:.3f} ms")

    ms_b2_plain, (prgb, ptrans, pckpt, pnproc) = host_ms(
        lambda: b1.tile_raster_fwd_train_plain(*targs))
    chk.close("B2", "1M 1080p train step B2 rgb", rgb, prgb)
    chk.close("B2", "1M 1080p train step B2 T", trans, ptrans)
    chk.equal("B2", "1M 1080p train step B2 nproc", nproc, pnproc)
    chk.equal("B2", "1M 1080p train step B2 ckpt", ckpt, pckpt)
    del prgb, ptrans, pckpt, pnproc
    ms_b3_plain, pg = host_ms(lambda: b3.tile_raster_bwd_plain(*bwd))
    chk.columns("B3", "1M 1080p train step B3 g_table", g_table, pg)
    log(f"[train] plain versions (host clock): B2 {ms_b2_plain:.3f} ms, "
        f"B3 {ms_b3_plain:.3f} ms")

    rows = int(rows_blended(bs.tile_starts, nproc).sum())
    dpad = bs.table.shape[1]
    bound_b2 = bound("B2", rows * 256 * FLOPS_PER_FRAGMENT,
                     rows * BLEND_ATTR_BYTES + ntile * 256 * 4 * 4
                     + seg_bytes + ntile * 4 + 2 * dpad * 4)
    bound_b3 = bound("B3", rows * 256 * FLOPS_PER_FRAGMENT_B3,
                     rows * BLEND_ATTR_BYTES + ntile * 256 * 5 * 4
                     + seg_bytes + ntile * 4 + 2 * dpad * 4
                     + 16 * dpad * 4)
    del splats, bs, g_table, pg, rgb, trans, ckpt, rgb_l, trans_l, img_l
    del t_l, g_rgb, g_trans, bwd, targs

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
    train_counts = counts()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_step = float(np.mean(step_ms))
    log(f"[train] 1M SH3 {FULL_W}x{FULL_H} fwd+bwd+update steps "
        f"{[f'{m:.3f}' for m in step_ms]} ms -> {ms_step:.3f} ms/step, "
        f"{FULL_W * FULL_H / ms_step / 1e3:.3f} Mpix/s, loss "
        f"{float(loss.detach()):.6g}, peak memory {train_peak:.3f} GiB, "
        f"launches {train_counts}")
    log(f"[train] device kernel time {device_ms:.3f} ms/step (profiler) -> "
        f"busy {device_ms / ms_step:.3f}, idle {1 - device_ms / ms_step:.3f} "
        f"of the unprofiled step")
    want = {"B1": 0, "B2": TRAIN_STEPS, "B3": TRAIN_STEPS}
    if train_counts != want:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {train_counts}")
    for name, p in zip(FIELDS, params):
        g = p.grad
        ok = g is not None and bool(torch.isfinite(g).all()) \
            and float(g.abs().max()) > 0
        log(f"[train] grad {name}: finite and nonzero {ok}, max|g| "
            f"{float(g.abs().max()) if g is not None else 0.0:.4g}")
        if not ok:
            raise AssertionError(f"the {name} gradient is zero or not finite")
    del sc, params

    # ---- 6. the trainer through its CLI
    with tempfile.TemporaryDirectory() as tmp:
        ply = Path(tmp) / "scene.ply"
        t0 = time.perf_counter()
        save_ply(scene_1m, ply)
        log(f"[trainer] {FULL_SPLATS} splats written to a PLY in "
            f"{time.perf_counter() - t0:.2f} s")
        zero_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train.main(["--gs-model", str(ply), "--self-distill",
                             "--steps", "3", "--width", str(FULL_W),
                             "--height", str(FULL_H), "--log-every", "1",
                             "--out", str(Path(tmp) / "trained.npz")])
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
    if app_counts != {"B1": 3, "B2": 0, "B3": 0}:
        raise AssertionError("serve renders did not go through B1 alone")

    # ---- 8. kernels line, card line, result
    fwd_src = "gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu"
    pallas = "gaussiansplattingviewer_tpu/ops/pallas/"
    line = {"kernels": [
        {"name": "tile_raster_fwd", "route": "cuda", "source": fwd_src,
         "replaces": pallas + "tile_raster_fwd.py:202",
         "launches": serve_counts["B1"], "max_abs_err": chk.err["B1"],
         "ms": ms_b1, "plain_ms": ms_b1_plain, "bound_ms": bound_b1[0],
         "bound_by": bound_b1[1], "library_ms": None},
        {"name": "tile_raster_fwd_train", "route": "cuda", "source": fwd_src,
         "replaces": pallas + "tile_raster_fwd.py:418",
         "launches": train_counts["B2"], "max_abs_err": chk.err["B2"],
         "ms": ms_b2, "plain_ms": ms_b2_plain, "bound_ms": bound_b2[0],
         "bound_by": bound_b2[1], "library_ms": None},
        {"name": "tile_raster_bwd", "route": "cuda",
         "source": "gaussiansplattingviewer_tpu_torch/csrc/"
                   "tile_raster_bwd.cu",
         "replaces": pallas + "tile_raster_bwd.py:614",
         "launches": train_counts["B3"], "max_abs_err": chk.err["B3"],
         "ms": ms_b3, "plain_ms": ms_b3_plain, "bound_ms": bound_b3[0],
         "bound_by": bound_b3[1], "library_ms": None},
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
