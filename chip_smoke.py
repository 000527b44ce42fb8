#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaussiansplattingviewer_tpu_torch)
on one CUDA card.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from csrc/ (one nvcc per source, started
     together) and print nvcc's -Xptxas -v report;
  3. each kernel against its plain PyTorch version on the 10k-splat golden
     scene at 1160x522, all 7 modes plus an opaque early-stop scene, and the
     rendered images against the stored goldens (tests/goldens);
  4. the main path at full size: the 1M-splat SH-3 bench scene at
     1920x1080 through render(), with CUDA-event stage times, the kernel's
     time, its plain version's time and the kernel held against the plain
     version on the same table;
  5. the serve app on 127.0.0.1 answering /info and three /render requests;
  6. a JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
# FP32 operations per (pixel, row) fragment in the blend kernel: 2 offsets,
# 9 for power, 4 for the rect test, exp, opacity product, clamp, 2 threshold
# tests, select, weight, 6 for the colour update, 2 for T
FLOPS_PER_FRAGMENT = 30
BLEND_ATTR_BYTES = 11 * 4  # table rows read per splat row (cx .. ry)

GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "goldens"
GOLDEN_MODES = ("SH1", "SH2", "SH3", "DEPTH", "BILLBOARD", "FLAT_BALL",
                "GAUSSIAN_BALL")


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


def max_err(got, want):
    """max |got - want| and the tolerance 1e-5 * max(1, |want|)."""
    return (float((got - want).abs().max()),
            1e-5 * max(1.0, float(want.abs().max())))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from gaussiansplattingviewer_tpu_torch.apps import serve
    from gaussiansplattingviewer_tpu_torch.config import (
        RenderConfig,
        RenderMode,
    )
    from gaussiansplattingviewer_tpu_torch.models import random_scene
    from gaussiansplattingviewer_tpu_torch.ops import binning
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build
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
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    kernels = ["tile_raster_fwd"]
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

    errs = []  # every kernel-vs-plain max abs diff of this run

    def hold(tag, got, want):
        err, tol = max_err(got, want)
        errs.append(err)
        log(f"[check] {tag}: max|diff| {err:.3e} (tol {tol:.1e})")
        if not err <= tol:
            raise AssertionError(f"{tag}: kernel disagrees with plain")

    # ---- 3. kernel vs plain on the golden scene, every mode
    W3, H3 = 1160, 522
    cam3 = Camera(h=H3, w=W3)
    cam3.fovy = 1.0
    eye3 = np.array([0.5, -0.4, 6.0])
    view3 = tf.look_at(eye3, [0, 0, 0], [0, -1, 0])
    proj3 = cam3.get_project_matrix()
    scene3 = random_scene(10_000, sh_degree=3, seed=5, extent=3.0,
                          mean_scale=0.04, anisotropy=0.7
                          ).pad_to_multiple(1024).to(dev)

    def kernel_vs_plain(tag, scene, cfg, view, proj, eye):
        splats = project(scene, view, proj, eye.astype(np.float32), cfg)
        bs = binning.bin_splats(splats, cfg)
        args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg)
        rgb, trans = b1.tile_raster_fwd(*args)
        torch.cuda.synchronize()
        prgb, ptrans = b1.tile_raster_fwd_plain(*args)
        hold(f"{tag} rgb", rgb, prgb)
        hold(f"{tag} T", trans, ptrans)
        return bs

    for name in GOLDEN_MODES:
        cfg = RenderConfig(width=W3, height=H3, mode=RenderMode[name])
        kernel_vs_plain(f"10k {name}", scene3, cfg, view3, proj3, eye3)
        img = render(scene3, view3, proj3, eye3.astype(np.float32), cfg)
        golden = np.load(GOLDEN_DIR / f"refres10k_{int(cfg.mode)}.npz")[
            "img"].astype(np.float32)
        diff = float(np.abs(img.cpu().numpy() - golden).max())
        atol = 2e-3 * max(1.0, float(np.abs(golden).max()))
        log(f"[golden] 10k {name}: max|img - golden| {diff:.3e} "
            f"(budget {atol:.1e})")
        if not diff <= atol:
            raise AssertionError(f"{name} render disagrees with its golden")

    opaque = random_scene(10_000, sh_degree=3, seed=5, extent=3.0,
                          mean_scale=0.08, anisotropy=0.7)
    opaque.opacity.fill_(0.99)
    cfg = RenderConfig(width=W3, height=H3)
    bs = kernel_vs_plain("10k opaque", opaque.pad_to_multiple(1024).to(dev),
                         cfg, view3, proj3, eye3)
    px, py = b1.tile_pixel_grid(cfg, cfg.tiles_y, device=dev)
    _, _, nproc = b1.blend_tiles_plain(bs.table, bs.tile_starts[:-1],
                                       bs.tile_counts, px, py, cfg)
    stopped = int((rows_blended(bs.tile_starts, nproc)
                   < bs.tile_counts).sum())
    log(f"[check] 10k opaque: early stop fired in {stopped} tiles")
    if stopped == 0:
        raise AssertionError("the opaque scene never stopped early")

    # ---- 4. the main path at full size
    W4, H4 = 1920, 1080
    cfg4 = RenderConfig(width=W4, height=H4)
    cam4 = Camera(h=H4, w=W4)
    cam4.fovy = 1.0
    eye4 = np.array([0.0, 0.0, 9.0], np.float32)
    view4 = tf.look_at(eye4, [0, 0, 0], [0, -1, 0])
    proj4 = cam4.get_project_matrix()
    t0 = time.perf_counter()
    big = random_scene(1_000_000, sh_degree=3, seed=0, extent=4.0,
                       mean_scale=0.015).pad_to_multiple(1024).to(dev)
    log(f"[full] scene of {len(big)} splats made in "
        f"{time.perf_counter() - t0:.2f} s")

    for _ in range(2):  # warm-up
        render(big, view4, proj4, eye4, cfg4)
    torch.cuda.synchronize()

    ms_proj, splats = cuda_ms(
        lambda: project(big, view4, proj4, eye4, cfg4), 3)
    ms_bin, bs = cuda_ms(lambda: binning.bin_splats(splats, cfg4), 3)
    blend_args = (bs.table, bs.tile_starts, bs.tile_counts, 0, cfg4)
    ms_blend, (rgb, trans) = cuda_ms(lambda: b1.tile_raster_fwd(*blend_args),
                                     10)
    t0 = time.perf_counter()
    px, py = b1.tile_pixel_grid(cfg4, cfg4.tiles_y, device=dev)
    prgb, ptrans, nproc = b1.blend_tiles_plain(
        bs.table, bs.tile_starts[:-1], bs.tile_counts, px, py, cfg4)
    torch.cuda.synchronize()
    ms_plain = (time.perf_counter() - t0) * 1e3
    hold("1M 1080p full frame rgb", rgb, prgb)
    hold("1M 1080p full frame T", trans, ptrans)

    gen = torch.Generator(device="cpu").manual_seed(0)
    sample = torch.randperm(cfg4.num_tiles, generator=gen)[:256].to(dev)
    srgb, strans, _ = b1.blend_tiles_plain(
        bs.table, bs.tile_starts[:-1][sample], bs.tile_counts[sample],
        px[sample], py[sample], cfg4)
    hold("1M 1080p 256 sampled tiles rgb", rgb[sample], srgb)
    hold("1M 1080p 256 sampled tiles T", trans[sample], strans)

    # the work this run's data needs: the rows each tile actually blended
    rows = int(rows_blended(bs.tile_starts, nproc).sum())
    flops = rows * 256 * FLOPS_PER_FRAGMENT
    nbytes = (rows * BLEND_ATTR_BYTES + cfg4.num_tiles * 256 * 4 * 4
              + (2 * cfg4.num_tiles + 1) * 4)
    bound_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    log(f"[full] blend rows {int(bs.tile_counts.sum())} listed, {rows} "
        f"blended before the early stop; {flops:.4g} FLOP, {nbytes} B -> "
        f"bound {bound_ms:.4f} ms by {bound_by} "
        f"(ops {bound_ops_ms:.4f} ms, bytes {bound_bytes_ms:.4f} ms)")

    # the main path: counts at 0, three frames through render(), read
    b1.tile_raster_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        img, aux = render_with_aux(big, view4, proj4, eye4, cfg4)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = b1.tile_raster_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_frame = float(np.mean(frame_ms))
    log(f"[full] 1M SH3 1920x1080 frames {[f'{m:.3f}' for m in frame_ms]} "
        f"ms -> {ms_frame:.3f} ms/frame, "
        f"{W4 * H4 / ms_frame / 1e3:.3f} Mpix/s")
    log(f"[full] stages (CUDA events): project {ms_proj:.3f} ms, bin "
        f"{ms_bin:.3f} ms, blend kernel {ms_blend:.3f} ms, blend plain "
        f"{ms_plain:.3f} ms")
    log(f"[full] num_duplicates {int(aux['num_duplicates'])}, truncated "
        f"{int(aux['truncated'])}, overflow {int(aux['overflow'])}, peak "
        f"memory {peak_gib:.3f} GiB, kernel launches {launches}")
    if launches != 3:
        raise AssertionError(f"blend kernel launched {launches} times in 3 "
                             "frames")
    img_np = img.cpu().numpy()
    if img_np.shape != (H4, W4, 3) or not np.isfinite(img_np).all():
        raise AssertionError("full-size image is not finite (H, W, 3)")
    if not (img_np.mean() > 0.01 and img_np.std() > 0.01):
        raise AssertionError("full-size image is blank")

    # ---- 5. the serve app
    args = serve.build_parser().parse_args(
        ["--random-scene", "1000000", "--width", "960", "--height", "540"])
    state = serve.build_state(args)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    b1.tile_raster_fwd.launches = 0
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
    serve_launches = b1.tile_raster_fwd.launches
    log(f"[serve] blend kernel launches for 3 renders: {serve_launches}")
    if serve_launches != 3:
        raise AssertionError("serve renders did not go through the kernel")

    # ---- 6. kernels line, card line, result
    line = {"kernels": [{
        "name": "tile_raster_fwd",
        "route": "cuda",
        "source": "gaussiansplattingviewer_tpu_torch/csrc/tile_raster_fwd.cu",
        "replaces": "gaussiansplattingviewer_tpu/ops/pallas/"
                    "tile_raster_fwd.py:202",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms_blend,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


def rows_blended(tile_starts, nproc):
    """Rows each tile blended before its early stop, from the windows it
    processed (the plain version's count)."""
    from gaussiansplattingviewer_tpu_torch.ops.binning import (
        KERNEL_CHUNK,
        SEGMENT_ALIGN,
    )

    s = tile_starts.to(torch.int64)
    base = s[:-1] // SEGMENT_ALIGN * SEGMENT_ALIGN
    return (torch.minimum(s[1:], base + nproc * KERNEL_CHUNK)
            - s[:-1]).clamp(min=0)


if __name__ == "__main__":
    sys.exit(main())
