"""Cross-backend comparison harness.

The JAX package's ``eval/compare.py`` for the port.  The reference could
only compare its two renderers by eyeballing a backend combo flip
(README.md:55 "slightly different results"; main.py:944-947).  Here the
comparison is quantitative and scriptable: render the same scene with any
subset of the port's backends ("kernel": the tile path, its blend on the
CUDA kernels for CUDA tensors; "tile": the same path on the tile executor;
"oracle": the global-sort blend), by default all three as in the JAX
package, and report per-pair image deltas + PSNR.  With ``device="cpu"``
the kernels run their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.eval.metrics import psnr


def compare_backends(
    scene,
    view,
    proj,
    cam_pos,
    cfg: RenderConfig,
    backends=("oracle", "tile", "kernel"),
    device=None,
) -> dict:
    """Render with each backend on ``device`` (default cuda) and compare
    all pairs.

    Returns {"<a>_vs_<b>": {"max_abs": float, "mean_abs": float,
    "psnr": float}} plus {"images": {backend: array}}.
    """
    from gaussiansplattingviewer_tpu_torch.ops.render import render

    images = {
        b: render(scene, view, proj, cam_pos, cfg, backend=b,
                  device=device).cpu().numpy()
        for b in backends
    }
    out = {"images": images}
    names = list(backends)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            d = np.abs(images[a] - images[b])
            out[f"{a}_vs_{b}"] = {
                "max_abs": float(d.max()),
                "mean_abs": float(d.mean()),
                "psnr": psnr(
                    np.clip(images[a], 0, 1), np.clip(images[b], 0, 1)
                ),
            }
    return out


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    from gaussiansplattingviewer_tpu_torch.apps.viewer import load_scene
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    ap = argparse.ArgumentParser(description="cross-backend flip test")
    ap.add_argument("--gs-model", default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--backends", nargs="+",
                    default=["oracle", "tile", "kernel"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    scene, bbox, center = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256)
    cfg = RenderConfig(width=args.width, height=args.height)
    cam = Camera(h=cfg.height, w=cfg.width)
    extent = float(np.linalg.norm(np.asarray(bbox[1]) - np.asarray(bbox[0])))
    eye = np.asarray(center) + np.array([0, 0, max(extent, 1.0)])
    view = tf.look_at(eye, center, [0, -1, 0])
    res = compare_backends(
        scene, view, cam.get_project_matrix(), eye.astype(np.float32), cfg,
        tuple(args.backends), device=args.device,
    )
    for k, v in res.items():
        if k != "images":
            print(k, v)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
