"""Real-PLY round trip on the card: a garden-scale scene through save_ply,
the NATIVE load_ply, autotune and the kernel render, with parity gates
against the in-memory scene.

The port of the JAX repository's ``scripts/ply_roundtrip_tpu.py``.  The
garden-scale synthetic (5.8M anisotropic splats, the scene ``bench``
documents) goes through the exact on-disk format the reference consumes:
``save_ply`` writes the official field layout with INVERSE activations
(log scale, logit opacity, raw quaternions, channel-major f_rest) to a
file under the system's temporary directory, and the native reader
(``csrc/gsv_native.cpp``) loads it back and re-applies the activations.
An unavailable native reader is an error, not a fallback to numpy.

Gates (``ply_roundtrip_tpu.py:84,120-121``, unchanged): every field within
1e-5 relative to its largest magnitude; the two autotuned frames, each
rendered through the ``kernel`` backend, within max|diff| < 1e-2 and
99.9th percentile < 5e-4, and finite.

  python -m gaussiansplattingviewer_tpu_torch.eval.ply_roundtrip \\
      [--n-splats 5800000] [--width 1920] [--height 1080] \\
      [--out chiprun_out/ply_roundtrip_cuda.json] [--device cuda]

Writes --out with the save, load and autotune seconds, the file's bytes,
each scene's fused decision and prefix rows, the diffs, ``pass`` and the
card's name and power limit; exits 0 iff every gate passes, non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import random_scene, save_ply
from gaussiansplattingviewer_tpu_torch.models.gaussians import _FIELDS
from gaussiansplattingviewer_tpu_torch.models.ply import _load_ply_native
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

FIELD_REL_TOL = 1e-5
IMG_MAX_TOL = 1e-2
IMG_P999_TOL = 5e-4


def roundtrip(n_splats: int, width: int, height: int, ply_path, device):
    """Save the garden-scale scene to ``ply_path``, load it back natively,
    autotune and render both.  Returns the result dict (``pass`` among
    its keys)."""
    dev = resolve_device(device)
    result = {"device": str(dev), "n_splats": n_splats}
    # garden-scale anisotropic scene, identical to bench --garden
    scene = random_scene(n_splats, sh_degree=3, seed=0, extent=6.0,
                         mean_scale=0.012, anisotropy=1.0, opacity_mix=True)
    t0 = time.perf_counter()
    save_ply(scene, ply_path)
    result["save_s"] = round(time.perf_counter() - t0, 2)
    result["file_bytes"] = os.path.getsize(ply_path)

    t0 = time.perf_counter()
    native = _load_ply_native(ply_path)
    if native is None:
        raise RuntimeError("the native PLY reader is unavailable or does "
                           "not take this file")
    loaded = native[0]
    result["native_load_s"] = round(time.perf_counter() - t0, 2)

    # save writes inverse activations (log / logit), so the round trip is
    # fp-close, not bit-equal
    ok = True
    result["field_rel_max"] = {}
    for f in _FIELDS:
        a = getattr(scene, f).numpy()
        b = getattr(loaded, f).numpy()
        d = float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))
        result["field_rel_max"][f] = d
        ok &= d < FIELD_REL_TOL

    # autotune and render both on the device: the loaded scene must give
    # the same frame (same tuner decisions, fp-close pixels)
    cfg = RenderConfig(width=width, height=height)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0, 0, 11.0], np.float32)
    view = np.asarray(tf.look_at(eye, np.zeros(3), [0, -1, 0]), np.float32)
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    imgs = {}
    for name, sc in (("mem", scene), ("ply", loaded)):
        on_dev = sc.to(dev)
        t0 = time.perf_counter()
        tuned = autotune(on_dev, [view], [proj], [eye], cfg, probe=True,
                         fused=None)
        result[f"autotune_s_{name}"] = round(time.perf_counter() - t0, 2)
        result[f"fused_{name}"] = bool(tuned.fused_grad)
        result[f"prefix_rows_{name}"] = int(tuned.prefix_rows)
        with torch.no_grad():
            img = render(on_dev.pad_to_multiple(1024), view, proj, eye,
                         tuned, backend="kernel", device=dev)
        imgs[name] = img.cpu().numpy()
        # the first scene's device tensors go before the second autotune
        del on_dev, img
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    d = np.abs(imgs["mem"] - imgs["ply"])
    result["img_max_abs_diff"] = float(d.max())
    result["img_p999_abs_diff"] = float(np.quantile(d, 0.999))
    # save_ply's inverse activations move the reloaded fields by ~1e-7
    # relative, enough to flip fragments on the discrete alpha_min /
    # in-rect / tight-cull cutoffs; each flip is a bounded pixel event and
    # the max over ~1e8 fragments is an order statistic, while the p99.9
    # gate pins the smooth-path agreement
    ok &= result["img_max_abs_diff"] < IMG_MAX_TOL
    ok &= result["img_p999_abs_diff"] < IMG_P999_TOL
    ok &= bool(np.isfinite(imgs["ply"]).all())
    result["pass"] = bool(ok)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-splats", type=int, default=5_800_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "ply_roundtrip_cuda.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions, for "
                    "the tests)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"ply_roundtrip: {e}", file=sys.stderr)
        return 2

    with tempfile.TemporaryDirectory(prefix="ply_roundtrip_") as tmp:
        result = roundtrip(args.n_splats, args.width, args.height,
                           Path(tmp) / "point_cloud.ply", args.device)
    if result["device"].startswith("cuda"):
        from gaussiansplattingviewer_tpu_torch.eval.gradcheck import (
            card_line,
        )

        result["card"] = card_line()
    else:
        result["card"] = "cpu"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    print(f"wrote {args.out}  pass={result['pass']}")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
