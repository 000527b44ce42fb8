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

--autotune tunes the config to the scene over the training poses before
the first step (ops/autotune.py) and re-tunes it whenever the binning's
overflow or truncation diagnostic fires (--overflow-check-every).  The
port's binning is exact, so of the tuned fields only table_budget_rows
changes what it computes.

--n-devices N (N > 1) shards the image's tile rows over N processes, one
per device (parallel/): run it under a launcher that starts them,

  torchrun --nproc-per-node N -m gaussiansplattingviewer_tpu_torch.apps.train \
      --n-devices N --self-distill ...

(``--device cpu`` takes a gloo group on the CPU).  Every rank builds the
same views and targets; the scene gradient is summed over the ranks before
each Adam step; rank 0 alone prints and writes files.  As in the JAX app,
the overflow re-tune is skipped when sharded.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gaussiansplattingviewer_tpu_torch.apps.viewer import load_scene
from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models.checkpoint import (
    save_npz,
    save_train_state,
)
from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)
from gaussiansplattingviewer_tpu_torch.ops.autotune import (
    autotune,
    binning_overflow,
)
from gaussiansplattingviewer_tpu_torch.ops.render import (
    BACKENDS,
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.parallel import (
    all_reduce_grads,
    initialize_distributed,
    make_mesh,
    make_sharded_render_fn,
    replicate_scene,
)
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
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="render() backend; with --n-devices every backend "
                    "but kernel blends on the tile executor, as in the JAX "
                    "app")
    ap.add_argument("--n-devices", type=int, default=0,
                    help="tile-row shards, one process each, started by a "
                    "launcher such as torchrun (0 or 1 = single process)")
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
    ap.add_argument("--autotune", action="store_true",
                    help="tune the config to the scene over the training "
                    "poses (ops/autotune.py) before the first step")
    ap.add_argument("--overflow-check-every", type=int, default=0,
                    help="every K steps, check binning overflow/truncation "
                    "on the current pose and RE-TUNE if the evolving scene "
                    "outgrew the config (0 = log_every; negative disables)")
    return ap


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
    backend = args.backend
    cfg = RenderConfig(width=args.width, height=args.height,
                       grad_fold_bf16=(args.grad_fold_bf16 == "on"))

    scene, bbox, center = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256)

    sharded = bool(args.n_devices and args.n_devices > 1)
    own_group = sharded and not dist.is_initialized()
    if sharded:
        world = int(os.environ.get("WORLD_SIZE", "1")) \
            if not dist.is_initialized() else dist.get_world_size()
        if world != args.n_devices:
            raise SystemExit(
                f"--n-devices {args.n_devices} needs {args.n_devices} "
                f"processes (WORLD_SIZE is {world}): launch with torchrun "
                f"--nproc-per-node {args.n_devices} -m "
                f"gaussiansplattingviewer_tpu_torch.apps.train ...")
        initialize_distributed(device=args.device)
        mesh = make_mesh(args.n_devices)
        dev = mesh.device
        scene = replicate_scene(scene, mesh)

        def make_render(c):
            return make_sharded_render_fn(mesh, c,
                                          use_kernel=(backend == "kernel"))
    else:
        dev = resolve_device(args.device)
        scene = scene.to(dev)

        def make_render(c):
            return lambda sc, view, proj, cam_pos: render(
                sc, view, proj, cam_pos, c, backend=backend, device=dev)
    rank0 = not sharded or mesh.rank == 0

    def say(*a):
        if rank0:
            print(*a, file=sys.stderr)

    render_fn = make_render(cfg)
    proj, triples = _poses_and_targets(args, scene, bbox, center, cfg,
                                       render_fn, dev)
    say(f"{len(triples)} training views, backend={backend}, device={dev}"
        + (f", {args.n_devices} tile-row shards" if sharded else ""))

    def tune(c, sc):
        tuned = autotune(
            sc, [v for v, _, _ in triples], [proj] * len(triples),
            [p for _, p, _ in triples],
            c.with_(pool_ladder=(), pool_huge_entries=0, table_budget_rows=0),
        )
        say(f"# autotuned: k1={tuned.dense_small_slots} "
            f"ladder={tuned.pool_ladder} "
            f"table_rows={tuned.table_budget_rows}")
        return tuned

    if args.autotune:
        cfg = tune(cfg, scene)
        render_fn = make_render(cfg)

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
    params = [getattr(scene, f) for f in _FIELDS]
    optimizer = torch.optim.Adam(params, lr=args.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    check_every = args.overflow_check_every or args.log_every
    first = mean_loss(scene, triples, proj, render_fn, args.loss)
    t0 = time.time()
    for i in range(args.steps):
        view, cam_pos, target = triples[i % len(triples)]
        optimizer.zero_grad(set_to_none=True)
        loss = image_loss(render_fn(scene, view, proj, cam_pos), target,
                          args.loss)
        loss.backward()
        if sharded:
            # each rank holds its band's share of the gradient
            all_reduce_grads(params, mesh)
        optimizer.step()
        if i % args.log_every == 0:
            say(f"step {i:5d}  loss {float(loss.detach()):.6f}")
        if check_every > 0 and not sharded and (i + 1) % check_every == 0:
            # the evolving scene can outgrow a tuned config (splats drift
            # or inflate); the diagnostics are the trigger to re-tune
            ovf, trunc = binning_overflow(scene, view, proj, cam_pos, cfg)
            if int(ovf) or int(trunc):
                say(f"step {i}: binning overflow={int(ovf)} "
                    f"truncated={int(trunc)} - re-tuning")
                cfg = tune(cfg, scene)
                render_fn = make_render(cfg)
        if args.ckpt_dir and rank0 and (i + 1) % args.ckpt_every == 0:
            save_train_state(args.ckpt_dir, i + 1, scene, optimizer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    last = mean_loss(scene, triples, proj, render_fn, args.loss)
    say(f"done: mean loss {first:.6f} -> {last:.6f} in {args.steps} steps "
        f"({dt / max(args.steps, 1) * 1000:.0f} ms/step)")
    if rank0:
        if args.loss == "l2":
            # machine-readable quality line for A/B gates (targets are in
            # [0,1], so mean L2 over views is an MSE and PSNR is meaningful)
            print(f"final_psnr_db {-10.0 * np.log10(max(last, 1e-12)):.3f}")
        save_npz(scene, args.out)
        say(f"saved {args.out}")
    if own_group:
        dist.destroy_process_group()
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
