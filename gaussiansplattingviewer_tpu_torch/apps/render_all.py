"""Batch driver: run the stereo dataset generator over many scenes.

The PyTorch port of the JAX package's ``apps/render_all.py``, which
replaces the reference's render_all.py (render_all.py:14-35): that script
shelled out ``python main.py`` per scene serially with a broad try/except
and a skip list.  Here scenes run in-process (one process, the kernels
built once) and failures are recorded per scene in the report instead of
silently swallowed; the exit code is 1 if any scene failed.

Usage:
  python -m gaussiansplattingviewer_tpu_torch.apps.render_all \\
      --scenes-root /data/scenes --colmap-root /data/colmap \\
      [--start 0 --end 270 --skip 42 117] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from gaussiansplattingviewer_tpu_torch.apps import dataset_gen


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes-root", required=True,
                    help="dir of scene dirs (each with point_cloud/...)")
    ap.add_argument("--colmap-root", default=None,
                    help="dir of COLMAP dirs; default: <scene>/sparse/0 "
                         "inside each scene (ref render_all.py:28-31)")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, nargs="*", default=[],
                    help="scene indices to skip (ref render_all.py:12)")
    ap.add_argument("--out", default="out_baseline_05")
    ap.add_argument("--baseline", type=float, default=-0.5)
    ap.add_argument("--width", type=int, default=1160)
    ap.add_argument("--height", type=int, default=522)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device passed to dataset_gen (default cuda)")
    ap.add_argument("--report", default="render_all_report.json")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scenes = sorted(
        d for d in os.listdir(args.scenes_root)
        if os.path.isdir(os.path.join(args.scenes_root, d))
    )
    if args.end is not None:
        scenes = scenes[args.start : args.end]
    else:
        scenes = scenes[args.start :]

    report = {}
    for i, scene in enumerate(scenes, start=args.start):
        if i in args.skip:
            report[scene] = "skipped"
            continue
        scene_dir = os.path.join(args.scenes_root, scene)
        colmap_dir = (
            os.path.join(args.colmap_root, scene)
            if args.colmap_root
            else os.path.join(scene_dir, "sparse", "0")
        )
        print(f"=== [{i}] {scene} ===", file=sys.stderr)
        try:
            sub_argv = [
                "--gs-model", scene_dir,
                "--colmap-poses", colmap_dir,
                "--out", args.out,
                "--baseline", str(args.baseline),
                "--width", str(args.width),
                "--height", str(args.height),
            ]
            if args.backend:
                sub_argv += ["--backend", args.backend]
            if args.device:
                sub_argv += ["--device", args.device]
            dataset_gen.generate(dataset_gen.build_parser().parse_args(sub_argv))
            report[scene] = "ok"
        except Exception as e:  # record, keep going (unlike silent ref)
            traceback.print_exc()
            report[scene] = f"failed: {e}"

    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    failed = [s for s, r in report.items() if r.startswith("failed")]
    print(f"done: {len(report) - len(failed)}/{len(report)} scenes ok",
          file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
