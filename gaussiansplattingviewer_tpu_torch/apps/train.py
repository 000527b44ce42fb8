"""Scene optimization CLI: fit Gaussian parameters to target images.

The PyTorch port of the JAX package's ``apps/train.py``: given camera poses
and target images, optimize means/scales/rotations/opacities/SH with Adam
through the differentiable tile renderer (kernels B2 and B3 on the card).

Modes:
  * --images DIR: real targets matched to COLMAP poses by index;
  * --self-distill: render targets from the loaded scene, perturb the
    parameters, and recover them — a built-in correctness/benchmark run
    needing no data.

Usage:
  python -m gaussiansplattingviewer_tpu_torch.apps.train --self-distill \\
      [--gs-model scene_dir] [--steps 200] [--width 256 --height 192] \\
      [--device cuda]

Not ported yet: the JAX app's --n-devices (mesh sharding), --autotune and
the overflow-triggered re-tune (the port's binning is exact and needs no
pool tuning).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import naive_gaussian
from gaussiansplattingviewer_tpu_torch.models.checkpoint import (
    save_npz,
    save_train_state,
)
from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)
from gaussiansplattingviewer_tpu_torch.models.ply import load_ply
from gaussiansplattingviewer_tpu_torch.ops.render import render, resolve_device
from gaussiansplattingviewer_tpu_torch.utils import colmap
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gs-model", default=None, help="initial scene (PLY dir)")
    ap.add_argument("--colmap-poses", default=None)
    ap.add_argument("--images", default=None, help="target image dir")
    ap.add_argument("--self-distill", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.2,
                    help="self-distill parameter noise scale")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--loss", choices=["l2", "l1"], default="l2")
    ap.add_argument("--backend", choices=["kernel", "oracle"],
                    default="kernel")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--out", default="trained_scene.npz")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--use-intrinsics", action="store_true",
                    help="projection from cameras.txt fx/fy/cx/cy (rescaled "
                    "to the render resolution) instead of the default lens")
    ap.add_argument("--grad-fold-bf16", choices=["on", "off"], default="on",
                    help="round each table row's gradient to bf16 before the "
                    "fold onto splats (config.grad_fold_bf16; default on, "
                    "as in the JAX package)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    return ap


def find_ply(gs_model: str) -> str:
    """Resolve a scene dir to its PLY like the reference
    (point_cloud/iteration_30000/point_cloud.ply)."""
    if gs_model.endswith(".ply"):
        return gs_model
    for it in ("iteration_30000", "iteration_7000"):
        p = os.path.join(gs_model, "point_cloud", it, "point_cloud.ply")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no point_cloud.ply under {gs_model}")


def load_scene(gs_model: str | None):
    """(scene, bbox, center): the PLY of a scene dir, else the 4-splat test
    scene (the JAX viewer's ``load_scene``, kept here until the viewer is
    ported)."""
    if gs_model:
        return load_ply(find_ply(gs_model))
    return naive_gaussian()


def _poses_and_targets(args, scene, bbox, center, cfg, render_fn, device):
    """Build (view, cam_pos, target) triples; targets are (H, W, 3) tensors
    in [0, 1] on ``device``."""
    cam = Camera(h=cfg.height, w=cfg.width)
    proj = cam.get_project_matrix()
    triples = []
    if args.colmap_poses:
        poses, ccams = colmap.load_sparse_dir(args.colmap_poses)
        if args.use_intrinsics and ccams:
            proj = colmap.camera_projection(ccams[0], cfg.width, cfg.height)
        for i, p in enumerate(poses):
            vl, _, cl, _ = colmap.pose_to_stereo_views(p)
            target = None
            if args.images:
                path = os.path.join(args.images, f"{i}.png")
                if os.path.exists(path):
                    target = torch.from_numpy(
                        read_image(path).astype(np.float32) / 255.0)
            triples.append([vl, cl, target])
    else:
        # orbit poses around the scene
        extent = float(np.linalg.norm(np.asarray(bbox[1])
                                      - np.asarray(bbox[0])))
        r = max(extent, 1.0)
        for i in range(8):
            ang = 2 * np.pi * i / 8
            eye = np.asarray(center) + r * np.array(
                [np.sin(ang), 0.0, np.cos(ang)])
            v = tf.look_at(eye, center, [0, -1, 0])
            triples.append([v, eye.astype(np.float32), None])

    # self-distill or fill missing targets by rendering the initial scene
    with torch.no_grad():
        for t in triples:
            if t[2] is None:
                t[2] = render_fn(scene, t[0], proj, t[1])
    return proj, [(v, c, torch.clamp(t.to(device), 0, 1))
                  for v, c, t in triples]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend
    cfg = RenderConfig(width=args.width, height=args.height,
                       grad_fold_bf16=(args.grad_fold_bf16 == "on"))

    scene, bbox, center = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256).to(dev)

    def render_fn(sc, view, proj, cam_pos):
        return render(sc, view, proj, cam_pos, cfg, backend=backend,
                      device=dev)

    proj, triples = _poses_and_targets(args, scene, bbox, center, cfg,
                                       render_fn, dev)
    print(f"{len(triples)} training views, backend={backend}, device={dev}",
          file=sys.stderr)

    if args.self_distill:
        rng = np.random.default_rng(0)

        def perturb(a, s):
            a = a.cpu().numpy()
            sigma = s * (np.abs(a) + 0.05)  # elementwise, floor for zeros
            return torch.from_numpy(
                (a + rng.normal(0, 1, a.shape) * sigma).astype(np.float32)
            ).to(dev)

        scene = dataclasses.replace(
            scene,
            xyz=perturb(scene.xyz, args.perturb * 0.05),
            sh=perturb(scene.sh, args.perturb),
        )

    # the five scene tensors are the optimizer's leaf parameters
    scene = GaussianData(*(getattr(scene, f).detach().clone()
                           .requires_grad_(True) for f in _FIELDS))
    optimizer = torch.optim.Adam([getattr(scene, f) for f in _FIELDS],
                                 lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    first = mean_loss(scene, triples, proj, render_fn, args.loss)
    t0 = time.time()
    for i in range(args.steps):
        view, cam_pos, target = triples[i % len(triples)]
        optimizer.zero_grad(set_to_none=True)
        loss = image_loss(render_fn(scene, view, proj, cam_pos), target,
                          args.loss)
        loss.backward()
        optimizer.step()
        if i % args.log_every == 0:
            print(f"step {i:5d}  loss {float(loss.detach()):.6f}",
                  file=sys.stderr)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_train_state(args.ckpt_dir, i + 1, scene, optimizer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    last = mean_loss(scene, triples, proj, render_fn, args.loss)
    print(
        f"done: mean loss {first:.6f} -> {last:.6f} in {args.steps} steps "
        f"({dt / max(args.steps, 1) * 1000:.0f} ms/step)",
        file=sys.stderr,
    )
    if args.loss == "l2":
        # machine-readable quality line for A/B gates (targets are in
        # [0,1], so mean L2 over views is an MSE and PSNR is meaningful)
        print(f"final_psnr_db {-10.0 * np.log10(max(last, 1e-12)):.3f}")
    save_npz(scene, args.out)
    print(f"saved {args.out}", file=sys.stderr)
    return 0 if last <= first else 1


def image_loss(img, target, kind: str):
    err = img - target
    return torch.mean(torch.abs(err)) if kind == "l1" \
        else torch.mean(err * err)


def mean_loss(scene, triples, proj, render_fn, kind: str) -> float:
    """Mean loss over all training views, without gradients."""
    with torch.no_grad():
        total = sum(image_loss(render_fn(scene, v, proj, c), t, kind)
                    for v, c, t in triples)
    return float(total / len(triples))


if __name__ == "__main__":
    raise SystemExit(main())
