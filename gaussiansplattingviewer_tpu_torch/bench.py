"""Benchmark: Mpix/s of a full training step at 1080p on one CUDA card (the
port of the JAX repository's ``bench.py``).

  python -m gaussiansplattingviewer_tpu_torch.bench [--iters 10]
      [--garden | --ply PATH] [--forward-only] [--no-fuse]
      [--backend kernel|tile|oracle] [--no-autotune] [--ref-reso]
      [--no-garden] [--no-parity] [--device cuda|cpu]

Scene: 1M synthetic Gaussians (``random_scene(seed=0, extent=4.0,
mean_scale=0.015)``, eye (0, 0, 9)); ``--garden`` takes the garden-sized
5.8M-splat anisotropic scene, ``--ply PATH`` a real one.  The same scenes,
camera (fovy 1.0) and padding (to a multiple of 1024) as ``bench.py``;
unless ``--no-autotune``, ``ops.autotune.autotune(probe=True, fused=None)``
sizes the config per scene first.

The measured step is a full training step: loss sum(img^2), backward, and
the SGD update p -= 1e-12 g on every leaf.  JAX fuses the ``--iters`` steps
into one lax.scan; here they are a Python loop with no host sync of the
bench's own (binning's own syncs stay, and their count per step is
printed).  ``--no-fuse`` computes gradients only, one call per step;
``--forward-only`` renders under no_grad.

Timing: the host clock from a torch.cuda.synchronize() to a
torch.cuda.synchronize() over the timed calls, after the warm-up.  One more
pass of the same calls runs under torch.profiler, outside the timed window:
it gives the device's kernel time per step (``device_ms_step``), the share
of the profiled window in which a kernel ran (``busy``) and the launches
per step, of the kernel wrappers (B1-B5) and by kernel name with its ms,
printed to stderr as ``# profiled: {...}``.

The last line of stdout is ONE JSON object with ``bench.py``'s keys:
``metric``, ``value``, ``unit``, ``vs_baseline`` (over 36.6 Mpix/s, the
reference viewer's estimated FORWARD-ONLY rate); ``fwd_mpix_s`` and
``fwd_vs_baseline`` (the forward re-measured after a default run);
``garden_ms_frame`` and ``garden_mpix_s`` (the garden step after a default
run of the 1M scene); ``parity_pass``; and ``card`` (nvidia-smi's name and
power limit), ``ms_step``, ``device_ms_step`` and ``busy`` of the headline
measurement.

Parity: unless ``--no-parity``, ``python -m
gaussiansplattingviewer_tpu_torch.eval.gradcheck --ci --bench-scale`` (the
card's check of the kernels against the tile executor) runs in a
subprocess; ``parity_pass`` is its exit code 0, null if it could not run,
and the bench exits 1 after the JSON line unless it is true.  The check
needs a card, so without one ``parity_pass`` is false.

``--device cpu`` (the tests) runs the kernels' plain versions; ``card`` is
then "cpu" and the device keys are null: a CPU run measures no device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import (
    GaussianData,
    load_ply,
    random_scene,
)
from gaussiansplattingviewer_tpu_torch.models.gaussians import _FIELDS
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.kernels import (
    tile_raster_bwd as _bwd,
)
from gaussiansplattingviewer_tpu_torch.ops.kernels import (
    tile_raster_fwd as _fwd,
)
from gaussiansplattingviewer_tpu_torch.ops.render import (
    BACKENDS,
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

LR = 1e-12  # keeps the scene statistically unchanged
REF_FORWARD_ONLY_MPIX_S = 36.6  # see the module docstring
PARITY_TIMEOUT_S = 2400
# the kernel wrappers' launch counters
WRAPPERS = {"B1": _fwd.tile_raster_fwd, "B2": _fwd.tile_raster_fwd_train,
            "B3": _bwd.tile_raster_bwd, "B4": _fwd.tile_raster_fwd_seeded,
            "B5": _bwd.tile_raster_bwd_fused}


def bench_scene(n: int):
    """The default scene, eye and look-at point (``bench.py:101-104``)."""
    scene = random_scene(n, sh_degree=3, seed=0, extent=4.0,
                         mean_scale=0.015)
    return scene, np.array([0, 0, 9.0]), np.zeros(3)


def garden_scene():
    """Garden-scale worst case: 5.8M splats (the MipNeRF-360 garden PLY at
    iteration_30000) with trained-3DGS-like anisotropy and a bimodal
    opacity mix (``bench.py:84-93``)."""
    scene = random_scene(5_800_000, sh_degree=3, seed=0, extent=6.0,
                         mean_scale=0.012, anisotropy=1.0, opacity_mix=True)
    return scene, np.array([0, 0, 11.0]), np.zeros(3)


def pose(cfg: RenderConfig, eye, look):
    """(view, proj, cam_pos) as float32 numpy, fovy 1.0: wide enough to see
    most of the synthetic box."""
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    view = np.asarray(tf.look_at(eye, look, [0, -1, 0]), np.float32)
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    return view, proj, np.asarray(eye, np.float32)


def train_steps(leaves: GaussianData, view, proj, cam_pos, cfg, backend,
                device, steps: int, lr: float = LR) -> torch.Tensor:
    """``steps`` training steps on ``leaves`` (tensors that require grad):
    loss sum(img^2), backward, p -= lr * g on every leaf.  No host sync of
    its own; each leaf's ``.grad`` holds the last step's gradient.  Returns
    the losses (steps,) on the device."""
    params = [getattr(leaves, f) for f in _FIELDS]
    losses = []
    for _ in range(steps):
        for p in params:
            p.grad = None
        img = render(leaves, view, proj, cam_pos, cfg, backend=backend,
                     device=device)
        loss = (img * img).sum()
        loss.backward()
        with torch.no_grad():
            for p in params:
                p.sub_(p.grad, alpha=lr)
        losses.append(loss.detach())
    return torch.stack(losses)


def gradients(leaves: GaussianData, view, proj, cam_pos, cfg, backend,
              device) -> list[torch.Tensor]:
    """The gradient of sum(img^2) per leaf, no update (``--no-fuse``)."""
    params = [getattr(leaves, f) for f in _FIELDS]
    img = render(leaves, view, proj, cam_pos, cfg, backend=backend,
                 device=device)
    return list(torch.autograd.grad((img * img).sum(), params))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counted_syncs(fn, dev):
    """Run ``fn`` once; return (its result, the synchronizing CUDA calls it
    made as torch's sync debug mode reports them; None off the card)."""
    if dev.type != "cuda":
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profiled(step, calls: int, frames: int, dev) -> dict:
    """One pass of ``calls`` calls of ``step`` under torch.profiler: device
    kernel time per step, the share of the window (host clock, synchronize
    to synchronize) in which a kernel ran, and launches per step of the
    kernel wrappers and, with ms per step, by kernel name.  Only the
    device is traced: recording every host op as well doubled the 1M
    step's window."""
    from torch.profiler import ProfilerActivity, profile

    for fn in WRAPPERS.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        _sync(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    count, us = collections.Counter(), collections.Counter()
    for e in kernels:
        count[e.name[:80]] += 1
        us[e.name[:80]] += e.time_range.end - e.time_range.start
    return {
        "device_ms_step": busy_us / 1e3 / frames,
        "busy": busy_us / window_us,
        "launches_per_step": {k: fn.launches / frames
                              for k, fn in WRAPPERS.items()},
        "kernels_per_step": {n: [count[n] / frames, t / 1e3 / frames]
                             for n, t in us.most_common()},
    }


def measure(args, scene: GaussianData, eye, look, iters: int, dev,
            label: str) -> dict:
    """Autotune and time the configured step on one scene.  Returns
    mpix_s, ms_frame and, on the card, the profiled pass's numbers."""
    scene = scene.pad_to_multiple(1024).to(dev)
    cfg = RenderConfig(width=args.width, height=args.height)
    view, proj, cam_pos = pose(cfg, eye, look)
    if not args.no_autotune:
        t0 = time.perf_counter()
        cfg = autotune(scene, [view], [proj], [cam_pos], cfg, probe=True,
                       fused=None)
        # the pool fields as the tuner writes them: the port bins exactly
        # and reads them only for the fused decision
        print(f"# autotuned ({time.perf_counter() - t0:.2f} s): "
              f"k1={cfg.dense_small_slots} ladder={cfg.pool_ladder} "
              f"huge={cfg.pool_huge_entries} "
              f"table_rows={cfg.table_budget_rows} fused={cfg.fused_grad} "
              f"K={cfg.prefix_rows} kb={cfg.prefix_budget_rows} "
              f"rb={cfg.residual_budget_rows} gb={cfg.grad_budget_rows}",
              file=sys.stderr)
    common = (view, proj, cam_pos, cfg, args.backend, dev)

    if args.forward_only:
        frames_per_call = 1

        def step():
            with torch.no_grad():
                return render(scene, view, proj, cam_pos, cfg,
                              backend=args.backend, device=dev)
    else:
        leaves = GaussianData(*(getattr(scene, f).detach().requires_grad_()
                                for f in _FIELDS))
        if args.no_fuse:
            frames_per_call = 1

            def step():
                return gradients(leaves, *common)
        else:
            frames_per_call = iters

            def step():
                return train_steps(leaves, *common, iters)

    calls = 1 if frames_per_call > 1 else iters
    frames = calls * frames_per_call
    # warm-up (bench.py:179-181); the host syncs counted on its last call
    for _ in range(max(args.warmup, 1) - 1 if frames_per_call == 1 else 0):
        step()
    _, syncs = _counted_syncs(step, dev)
    _sync(dev)

    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    _sync(dev)
    dt = time.perf_counter() - t0

    ms_frame = dt / frames * 1000
    out = {"mpix_s": cfg.width * cfg.height / 1e6 * frames / dt,
           "ms_frame": ms_frame, "device_ms_step": None, "busy": None}
    if dev.type == "cuda":
        out.update(profiled(step, calls, frames, dev))
        out["host_syncs_per_step"] = syncs / frames_per_call
        # the same device time against the unprofiled step
        out["device_share_of_timed_step"] = out["device_ms_step"] / ms_frame
        print("# profiled: " + json.dumps({"label": label, **out}),
              file=sys.stderr)
    busy = "not measured" if out["busy"] is None else f"{out['busy']:.3f}"
    print(f"# backend={args.backend} n={len(scene)} {cfg.width}x"
          f"{cfg.height} frames={frames} time={dt:.2f}s "
          f"ms/frame={ms_frame:.3f} busy={busy} [{label}]", file=sys.stderr)
    return out


def parity_check() -> bool | None:
    """The card's parity check in a subprocess: True iff it exits 0, None
    if it could not run."""
    repo_root = str(Path(__file__).resolve().parents[1])
    # the child does not inherit the parent's sys.path: add the checkout,
    # keeping whatever PYTHONPATH already holds
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "gaussiansplattingviewer_tpu_torch.eval.gradcheck", "--ci",
             "--bench-scale"],
            capture_output=True, text=True, timeout=PARITY_TIMEOUT_S,
            env=env)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"# parity check failed to run: {e}", file=sys.stderr)
        return None
    sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-2000:])
    return proc.returncode == 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-splats", type=int, default=1_000_000)
    ap.add_argument("--garden", action="store_true",
                    help="garden-sized scene: 5.8M anisotropic splats")
    ap.add_argument("--ply", type=str, default=None)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--no-fuse", action="store_true",
                    help="gradients only, one call per step, instead of "
                    "iters training steps per call")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel")
    ap.add_argument("--no-autotune", action="store_true",
                    help="skip the per-scene config tuning")
    ap.add_argument("--ref-reso", action="store_true",
                    help="measure at the reference viewer's default "
                    "resolution (1160x522) FORWARD-ONLY")
    ap.add_argument("--no-garden", action="store_true",
                    help="skip the garden-scale (5.8M splat) second "
                    "measurement")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the card's parity check")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions, for "
                    "the tests)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ref_reso:
        args.width, args.height = 1160, 522
        args.forward_only = True
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2

    if args.ply:
        scene, _, center = load_ply(args.ply)
        eye, look = center + np.array([0, 0, 3.0]), center
    elif args.garden:
        scene, eye, look = garden_scene()
    else:
        scene, eye, look = bench_scene(args.n_splats)

    head = measure(args, scene, eye, look, args.iters, dev,
                   "headline")
    mpix_s = head["mpix_s"]
    result = {
        "metric": "Mpix/s/chip fwd 1080p" if args.forward_only
        else "Mpix/s/chip fwd+bwd 1080p",
        "value": round(mpix_s, 3),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / REF_FORWARD_ONLY_MPIX_S, 3),
    }

    if not args.forward_only and not args.no_fuse:
        # the denominator is the reference's FORWARD-ONLY display loop,
        # while the headline includes backward and update: record the
        # forward too
        args.forward_only = True
        fwd = measure(args, scene, eye, look, max(args.iters, 4), dev,
                      "forward")
        args.forward_only = False
        result["fwd_mpix_s"] = round(fwd["mpix_s"], 3)
        result["fwd_vs_baseline"] = round(
            fwd["mpix_s"] / REF_FORWARD_ONLY_MPIX_S, 3)

    run_garden = not (args.no_garden or args.garden or args.ply
                      or args.forward_only or args.ref_reso)
    if run_garden:
        del scene
        g_scene, g_eye, g_look = garden_scene()
        garden = measure(args, g_scene, g_eye, g_look, min(args.iters, 4),
                         dev, "garden")
        result["garden_ms_frame"] = round(garden["ms_frame"], 1)
        result["garden_mpix_s"] = round(garden["mpix_s"], 3)

    if dev.type == "cuda":
        from gaussiansplattingviewer_tpu_torch.eval.gradcheck import (
            card_line,
        )

        result["card"] = card_line()
    else:
        result["card"] = "cpu"
    result["ms_step"] = round(head["ms_frame"], 3)
    for key in ("device_ms_step", "busy"):
        result[key] = None if head[key] is None else round(head[key], 3)

    if not args.no_parity:
        result["parity_pass"] = parity_check()

    print(json.dumps(result), flush=True)
    # a failed, crashed or impossible parity check fails the bench
    if "parity_pass" in result and result["parity_pass"] is not True:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
