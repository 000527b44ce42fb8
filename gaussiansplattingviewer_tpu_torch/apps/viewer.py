"""Headless viewer CLI: render a Gaussian scene to PNG frames.

The PyTorch port of the JAX package's ``apps/viewer.py``, the replacement
for the reference's GLFW/imgui viewer loop (main.py:593-1078).  Windowing
is gone; everything the UI controlled is a flag, and the interactive orbit
camera survives as the scripted orbit and pose-replay paths:

  reference UI control                    -> CLI flag
  ------------------------------------------------------------------
  backend combo (main.py:944-947)        -> --backend {kernel,tile,oracle}
  render-mode combo (main.py:985-987)    -> --mode {sh0,sh1,sh2,sh3,depth,
                                             billboard,flat-ball,gaussian-ball}
  scale-modifier slider                   -> --scale-modifier
  fov slider (main.py:978-982)           -> --fovy
  save-image button (main.py:1002)       -> every frame is saved
  WASD / mouse orbit                      -> --orbit N (frames around target)
  middle-click pose dump (main.py:418-434)-> --save-poses camera_data.csv

DEPTH frames are written as 16-bit disparity PNGs (x65535).  Frames render
on ``cuda`` (the blend on kernel B1) unless ``--device cpu`` is given.

Usage:
  python -m gaussiansplattingviewer_tpu_torch.apps.viewer --gs-model scene_dir \\
      [--orbit 60] [--out out_frames] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import naive_gaussian
from gaussiansplattingviewer_tpu_torch.models.ply import load_ply
from gaussiansplattingviewer_tpu_torch.ops.render import (
    BACKENDS,
    render,
    render_with_aux,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.utils.image_io import (
    ensure_dirs,
    write_disparity16,
    write_rgb8,
)

MODE_NAMES = {
    # reference UI table main.py:98 -> render_mod = idx - 3 (main.py:985-987)
    "gaussian-ball": RenderMode.FLAT_BALL,
    "billboard": RenderMode.BILLBOARD,
    "depth": RenderMode.DEPTH,
    "sh0": RenderMode.SH0,
    "sh1": RenderMode.SH1,
    "sh2": RenderMode.SH2,
    "sh3": RenderMode.SH3,
    "flat-ball": RenderMode.FLAT_BALL,
    "gaussian-ball-soft": RenderMode.GAUSSIAN_BALL,
}


def find_ply(gs_model: str) -> str:
    """Resolve a scene dir to its PLY like the reference
    (point_cloud/iteration_30000/point_cloud.ply, main.py:722)."""
    if gs_model.endswith(".ply"):
        return gs_model
    for it in ("iteration_30000", "iteration_7000"):
        p = os.path.join(gs_model, "point_cloud", it, "point_cloud.ply")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no point_cloud.ply under {gs_model}")


def load_scene(gs_model: str | None):
    """(scene on the CPU, bbox, center): the PLY of a scene dir (or .ply),
    else the 4-splat test scene."""
    if gs_model:
        return load_ply(find_ply(gs_model))
    return naive_gaussian()


def save_frame(path, img, cfg: RenderConfig) -> None:
    """A frame as the viewer writes it: DEPTH as 16-bit disparity, else
    8-bit RGB clipped to [0, 1]."""
    if cfg.mode == RenderMode.DEPTH:
        write_disparity16(path, img[..., 0])
    else:
        write_rgb8(path, np.clip(img, 0.0, 1.0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gs-model", "--gs_model", dest="gs_model", default=None,
                    help="scene dir (or .ply); default: 4-splat test scene")
    ap.add_argument("--width", type=int, default=1160)   # ref main.py:635
    ap.add_argument("--height", type=int, default=522)   # ref main.py:634
    ap.add_argument("--mode", choices=sorted(MODE_NAMES), default="sh3")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--scale-modifier", type=float, default=1.0)
    ap.add_argument("--fovy", type=float, default=None,
                    help="vertical fov in radians (default: reference lens)")
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--target", type=float, nargs=3, default=None)
    ap.add_argument("--up", type=float, nargs=3, default=[0.0, -1.0, 0.0])
    ap.add_argument("--orbit", type=int, default=0,
                    help="render N frames orbiting the target")
    ap.add_argument("--orbit-radius", type=float, default=None)
    ap.add_argument("--out", default="out_frames")
    ap.add_argument("--save-poses", default=None,
                    help="append rendered camera poses to this CSV "
                         "(front,up,position triplets like main.py:418-434)")
    ap.add_argument("--debug", action="store_true",
                    help="sanitizer mode: per-frame finiteness + binning "
                         "overflow diagnostics (RenderConfig.debug)")
    ap.add_argument("--poses-csv", default=None,
                    help="replay poses recorded in a camera_data.csv "
                         "(9 columns: front, up, position)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    scene, bbox, center = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256).to(dev)
    print(f"loaded {len(scene)} gaussians (sh_dim={scene.sh_dim}), "
          f"backend={args.backend}, device={dev}", file=sys.stderr)

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        mode=MODE_NAMES[args.mode],
        scale_modifier=args.scale_modifier,
        debug=args.debug,
    )

    def frame(view, eye):
        a = (scene, view, proj, eye.astype(np.float32), cfg)
        if not args.debug:
            return render(*a, backend=args.backend, device=dev).cpu().numpy()
        img, aux = render_with_aux(*a, backend=args.backend, device=dev)
        bad = {
            k: int(aux[k])
            for k in ("nonfinite_splats", "nonfinite_pixels", "overflow",
                      "truncated")
            if k in aux and int(aux[k]) > 0
        }
        if bad:
            print(f"DEBUG diagnostics: {bad}", file=sys.stderr)
        return img.cpu().numpy()

    cam = Camera(h=cfg.height, w=cfg.width)
    if args.fovy:
        cam.fovy = args.fovy
    proj = cam.get_project_matrix()

    target = np.asarray(args.target if args.target else center, np.float64)
    if args.eye:
        eye0 = np.asarray(args.eye, np.float64)
    else:
        extent = float(np.linalg.norm(np.asarray(bbox[1])
                                      - np.asarray(bbox[0])))
        eye0 = target + np.array([0.0, 0.0, max(extent, 1.0)])
    radius = args.orbit_radius or float(np.linalg.norm(eye0 - target))
    up = np.asarray(args.up, np.float64)

    csv_poses = None
    if args.poses_csv:
        csv_poses = []
        with open(args.poses_csv, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 9:
                    vals = [float(x) for x in row[:9]]
                    csv_poses.append(
                        (np.array(vals[0:3]), np.array(vals[3:6]),
                         np.array(vals[6:9]))
                    )
        print(f"replaying {len(csv_poses)} recorded poses", file=sys.stderr)

    ensure_dirs(args.out)
    n_frames = len(csv_poses) if csv_poses else max(args.orbit, 1)
    t0 = time.time()
    for i in range(n_frames):
        path = os.path.join(args.out, f"{i}.png")
        if csv_poses:
            front, up_i, eye = csv_poses[i]
            save_frame(path, frame(tf.look_at(eye, eye + front, up_i), eye),
                       cfg)
            continue
        if args.orbit:
            ang = 2 * np.pi * i / args.orbit
            # orbit in the plane orthogonal to `up`, like the reference's
            # yaw orbit (util.py:152-163)
            base = eye0 - target
            axis = up / np.linalg.norm(up)
            x = base - axis * np.dot(base, axis)
            x = x / max(np.linalg.norm(x), 1e-9) * radius
            y = np.cross(axis, x)
            eye = target + x * np.cos(ang) + y * np.sin(ang) \
                + axis * np.dot(base, axis)
        else:
            eye = eye0
        save_frame(path, frame(tf.look_at(eye, target, up), eye), cfg)
        if args.save_poses:
            front = tf.normalize(target - eye)
            with open(args.save_poses, "a", newline="") as f:
                csv.writer(f).writerow(list(front) + list(up) + list(eye))
    dt = time.time() - t0
    print(f"rendered {n_frames} frame(s) to {args.out}/ "
          f"({dt / n_frames * 1000:.1f} ms/frame avg incl. IO)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
