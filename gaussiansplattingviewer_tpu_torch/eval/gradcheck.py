"""Parity check on the card: the kernels against the tile executor, forward
image and per-field gradients.

The port of the JAX repository's ``scripts/tpu_gradcheck.py``.  It renders
the SAME scene through the ``kernel`` backend (the CUDA kernels) and the
``tile`` backend (the tile executor, plain PyTorch, ops/blend.py) on the
SAME device and compares the forward pixels and every gradient field of
mean(img^2).  The two share projection, binning and the fold but blend on
independent code: 256-row windows read back to front from checkpoints
against 16-row chunks re-traversed front to back.  The kernels' own plain
versions repeat the kernels' order step by step, so this is the card's
independent check.

  python -m gaussiansplattingviewer_tpu_torch.eval.gradcheck \\
      [--ci] [--bench-scale] [--out chiprun_out/parity_cuda.json]

Without --ci it runs on the card and reports.
--ci: needs a CUDA card (exits non-zero without one); asserts the
      thresholds, writes the result with the card's name and power limit
      to --out and exits 1 on a failure.
--bench-scale: ALSO run a 500k-splat 1920x1080 case on the fused path
      (prefix_rows 512): the kernel route runs B2, B4 and B5 there, the
      tile route stays classic.  The toy case runs B1, B2 and B3.

Thresholds (``scripts/tpu_gradcheck.py:48-62``, unchanged):
  * forward max|diff| < 5e-4: at most one alpha_min-cutoff fragment flip,
    plus the early stop, tested every 256 rows by the kernels and every
    16 by the tile executor (each bounded by early_stop_transmittance);
  * per-field gradient 99th-percentile relative error < 5e-4 (bench
    scale 1e-4), the smooth-path agreement;
  * per-field MAX relative error < 2e-3 (bench scale 5e-3), dominated by
    single-fragment cutoff flips, whose count grows with the fragments.

The bf16 gradient fold (cfg.grad_fold_bf16) is off here: both routes share
it, and rounding near-equal values to bf16 would measure the fold.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)
from gaussiansplattingviewer_tpu_torch.models.random_scene import (
    random_scene,
)
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

FWD_TOL = 5e-4
REL_MAX_TOL = 2e-3
REL_P99_TOL = 5e-4
# bench scale: rel_max is an order statistic of ~17M cutoff decisions, so
# it grows with the scene; the smooth-path p99 tightens instead
BS_FWD_TOL = 5e-4
BS_REL_MAX_TOL = 5e-3
BS_REL_P99_TOL = 1e-4
REPORT_FIELDS = ("xyz", "scale", "rot", "opacity", "sh")
TOY = dict(n_splats=5_000, width=256, height=192, mean_scale=0.04,
           extent=2.0, sh_degree=1, eye_z=6.0, seed=1)
BENCH_SCALE = dict(n_splats=500_000, width=1920, height=1080,
                   mean_scale=0.015, extent=4.0, sh_degree=3, eye_z=9.0,
                   seed=0, fwd_tol=BS_FWD_TOL, rel_max_tol=BS_REL_MAX_TOL,
                   rel_p99_tol=BS_REL_P99_TOL,
                   cfg_extra=dict(fused_grad=True, prefix_rows=512,
                                  residual_budget_rows=1_048_576))


def _image_and_grads(scene, view, proj, cam_pos, cfg, backend, dev):
    """The image under no_grad, and the gradients of mean(img^2) per
    field, both as numpy."""
    with torch.no_grad():
        img = render(scene, view, proj, cam_pos, cfg, backend=backend,
                     device=dev)
    leaves = GaussianData(*(getattr(scene, f).detach().clone()
                            .requires_grad_(True) for f in _FIELDS))
    out = render(leaves, view, proj, cam_pos, cfg, backend=backend,
                 device=dev)
    torch.mean(out * out).backward()
    return img.cpu().numpy(), {f: getattr(leaves, f).grad.cpu().numpy()
                               for f in REPORT_FIELDS}


def run_case(n_splats, width, height, mean_scale, extent, sh_degree,
             eye_z, seed, fwd_tol=FWD_TOL, rel_max_tol=REL_MAX_TOL,
             rel_p99_tol=REL_P99_TOL, cfg_extra=None, device=None) -> dict:
    """One scene through the kernel and the tile backend on ``device``
    (default cuda): the forward's max|diff| and, per field, rel_max,
    rel_p99, abs_max and grad_scale (the tile route's max|g|), with
    ``pass`` against the thresholds."""
    dev = resolve_device(device)
    cfg = RenderConfig(width=width, height=height, grad_fold_bf16=False)
    if cfg_extra:
        cfg = cfg.with_(**cfg_extra)
    scene = random_scene(n_splats, sh_degree=sh_degree, seed=seed,
                         extent=extent, mean_scale=mean_scale).to(dev)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    view = np.asarray(tf.look_at(np.array([0, 0, eye_z]), np.zeros(3),
                                 [0, -1, 0]), np.float32)
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    cam_pos = np.array([0, 0, eye_z], np.float32)

    img_k, g_k = _image_and_grads(scene, view, proj, cam_pos, cfg, "kernel",
                                  dev)
    img_t, g_t = _image_and_grads(scene, view, proj, cam_pos, cfg, "tile",
                                  dev)
    fwd_max = float(np.abs(img_k - img_t).max())
    result = {
        "device": str(dev),
        "config": {"n_splats": n_splats, "width": cfg.width,
                   "height": cfg.height, "grad_fold_bf16": False,
                   "fused_grad": bool(cfg.fused_grad),
                   "prefix_rows": int(cfg.prefix_rows)},
        "fwd_max_abs_diff": fwd_max,
        "fields": {},
    }
    print(f"[n={n_splats} {width}x{height}] fwd kernel vs tile max|diff|: "
          f"{fwd_max:.3e}")
    ok = fwd_max < fwd_tol
    for name in REPORT_FIELDS:
        a, b = g_k[name], g_t[name]
        denom = float(np.abs(b).max()) + 1e-12
        d = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
        rel_max = float(d.max() / denom)
        rel_p99 = float(np.quantile(d / denom, 0.99))
        result["fields"][name] = {"rel_max": rel_max, "rel_p99": rel_p99,
                                  "abs_max": float(d.max()),
                                  "grad_scale": denom}
        print(f"grad {name:8s}: rel_max={rel_max:.3e}  "
              f"rel_p99={rel_p99:.3e}  |tile|max={denom:.3e}")
        ok &= rel_max < rel_max_tol and rel_p99 < rel_p99_tol
    result["thresholds"] = {"fwd": fwd_tol, "rel_max": rel_max_tol,
                            "rel_p99": rel_p99_tol}
    result["pass"] = bool(ok)
    return result


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ci", action="store_true",
                    help="on a CUDA card: assert the thresholds, write "
                    "--out, exit 1 on a failure")
    ap.add_argument("--n-splats", type=int, default=TOY["n_splats"])
    ap.add_argument("--bench-scale", action="store_true",
                    help="also verify a 500k-splat 1080p case on the "
                    "fused path (kernels B2, B4, B5)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "parity_cuda.json"))
    args = ap.parse_args(argv)
    if args.ci and not torch.cuda.is_available():
        print("gradcheck --ci runs on a CUDA card", file=sys.stderr)
        return 2

    result = run_case(**{**TOY, "n_splats": args.n_splats})
    ok = result["pass"]
    if args.bench_scale:
        result["bench_scale"] = run_case(**BENCH_SCALE)
        ok = ok and result["bench_scale"]["pass"]
    if args.ci:
        result["card"] = {"name": torch.cuda.get_device_name(0),
                          "nvidia_smi": card_line()}
        result["pass"] = bool(ok)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {args.out}  pass={ok}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
