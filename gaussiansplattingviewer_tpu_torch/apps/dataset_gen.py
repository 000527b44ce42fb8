"""Stereo training-data generator: left/right/disparity triplets from COLMAP poses.

The PyTorch port of the JAX package's ``apps/dataset_gen.py``, the rebuild
of the reference's dataset loop (main.py:793-923): for every COLMAP pose,
render
  * left RGB   (current render mode, pose view matrix),
  * disparity  (DEPTH mode: per-splat |x_l - x_r| in image-width units,
                scaled x65535 to uint16 — main.py:875-879),
  * right RGB  (view translated by the stereo baseline in view space,
                main.py:376-380),
into ``<out>/<scene>/{left,right,depth}/<index>.png`` (main.py:702-711),
three frames (three launches of kernel B1) per pose on ``cuda`` unless
``--device cpu`` is given.

Differences from the reference, by design:
  * headless and batched — no GLFW window, no FBO round-trips, no every-5th
    -frame settling (main.py:808-815): each pose renders exactly once;
  * resumable like the reference's saved_image[] (main.py:713,839) but
    across restarts: existing complete triplets are skipped unless --force;
  * a manifest.json records scene, pose count, baseline and resolution.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from gaussiansplattingviewer_tpu_torch.apps.viewer import MODE_NAMES, load_scene
from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops.render import (
    BACKENDS,
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import colmap
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.utils.image_io import (
    ensure_dirs,
    write_disparity16,
    write_rgb8,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gs-model", "--gs_model", dest="gs_model", required=True)
    ap.add_argument("--colmap-poses", "--colmap_poses", dest="colmap_poses",
                    required=True, help="COLMAP sparse dir with images.txt")
    ap.add_argument("--out", default="out_baseline_05")  # ref main.py:696
    ap.add_argument("--baseline", type=float, default=-0.5)  # ref main.py:280
    ap.add_argument("--width", type=int, default=1160)
    ap.add_argument("--height", type=int, default=522)
    ap.add_argument("--mode", choices=sorted(MODE_NAMES), default="sh3")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--scale-modifier", type=float, default=1.0)
    ap.add_argument("--force", action="store_true",
                    help="re-render even if the triplet exists")
    ap.add_argument("--max-poses", type=int, default=None)
    ap.add_argument("--use-intrinsics", action="store_true",
                    help="build the projection from cameras.txt fx/fy/cx/cy "
                    "(rescaled to the render resolution) instead of the "
                    "default lens; the reference parses these and discards "
                    "them (main.py:628-632)")
    return ap


def triplet_paths(scene_dir: str, idx: int):
    return (
        os.path.join(scene_dir, "left", f"{idx}.png"),
        os.path.join(scene_dir, "right", f"{idx}.png"),
        os.path.join(scene_dir, "depth", f"{idx}.png"),
    )


def generate(args) -> int:
    dev = resolve_device(args.device)

    poses, cams = colmap.load_sparse_dir(args.colmap_poses)
    if args.max_poses:
        poses = poses[: args.max_poses]
    print(f"{len(poses)} poses from {args.colmap_poses}", file=sys.stderr)

    scene, _, _ = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256).to(dev)

    scene_name = os.path.basename(os.path.normpath(args.gs_model)) or "0000"
    scene_dir = os.path.join(args.out, scene_name)
    ensure_dirs(
        os.path.join(scene_dir, "left"),
        os.path.join(scene_dir, "right"),
        os.path.join(scene_dir, "depth"),
    )

    cfg_rgb = RenderConfig(
        width=args.width, height=args.height,
        mode=MODE_NAMES[args.mode], scale_modifier=args.scale_modifier,
        stereo_baseline=args.baseline,
    )
    cfg_disp = cfg_rgb.with_(mode=RenderMode.DEPTH)
    cam = Camera(h=args.height, w=args.width)
    default_proj = cam.get_project_matrix()

    def frame(view, proj, cam_pos, cfg):
        return render(scene, view, proj, cam_pos, cfg, backend=args.backend,
                      device=dev).cpu().numpy()

    done = 0
    t0 = time.time()
    for idx, pose in enumerate(poses):
        lp, rp, dp = triplet_paths(scene_dir, idx)
        if not args.force and all(os.path.exists(p) for p in (lp, rp, dp)):
            continue
        proj = default_proj
        if args.use_intrinsics:
            ccam = colmap.camera_for_pose(cams, pose)
            if ccam is not None:
                proj = colmap.camera_projection(
                    ccam, args.width, args.height
                )
        view_l, view_r, cam_l, cam_r = colmap.pose_to_stereo_views(
            pose, baseline=args.baseline
        )
        img_l = frame(view_l, proj, cam_l, cfg_rgb)
        disp = frame(view_l, proj, cam_l, cfg_disp)
        img_r = frame(view_r, proj, cam_r, cfg_rgb)
        write_rgb8(lp, np.clip(img_l, 0, 1))
        write_rgb8(rp, np.clip(img_r, 0, 1))
        write_disparity16(dp, disp[..., 0])
        done += 1
        if done % 10 == 0:
            print(f"  {done} triplets ({(time.time()-t0)/done*1000:.0f} "
                  f"ms each)", file=sys.stderr)

    manifest = {
        "scene": scene_name,
        "n_poses": len(poses),
        "rendered_this_run": done,
        "baseline": args.baseline,
        "width": args.width,
        "height": args.height,
        "mode": args.mode,
        "use_intrinsics": bool(args.use_intrinsics),
        "backend": args.backend,
        "n_gaussians": int(len(scene)),
    }
    with open(os.path.join(scene_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"scene {scene_name}: {done} new triplets -> {scene_dir}",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    return generate(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
