"""Top-level render API: render(scene, view, proj, cam_pos, cfg) -> image.

Backends:
  * "kernel" (default): project -> bin -> tile blend, the blend on the
    hand-written CUDA kernels for CUDA tensors (their plain versions on
    the CPU), JAX's "pallas";
  * "tile": the same pipeline with the blend on the tile executor
    (ops/blend.py), plain PyTorch on any device, JAX's "tile" (its XLA
    executor);
  * "oracle": global-sort full-image blend (ops/raster_oracle.py), the
    ground truth for small scenes.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Literal, get_args

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.raster_oracle import (
    rasterize_oracle,
)
from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import rasterize_tiles

Backend = Literal["kernel", "tile", "oracle"]
BACKENDS = get_args(Backend)  # the apps' --backend choices


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to render with the "
            "plain PyTorch executors on the CPU"
        )
    return dev


def _render(scene, view, proj, cam_pos, cfg, backend, device, return_aux):
    dev = resolve_device(device)
    splats = project(scene.to(dev), view, proj, cam_pos, cfg)
    if backend == "oracle":
        return rasterize_oracle(splats, cfg, return_aux=return_aux)
    if backend in ("kernel", "tile"):
        return rasterize_tiles(splats, cfg, return_aux=return_aux,
                               use_kernel=backend == "kernel")
    raise ValueError(f"unknown backend {backend!r}")


def render(scene: GaussianData, view, proj, cam_pos, cfg: RenderConfig,
           backend: Backend = "kernel", device=None) -> torch.Tensor:
    """Render a scene to an (H, W, 3) float32 image on ``device`` (clamp for
    display).  view/proj: (4, 4) math-convention matrices, cam_pos (3,)."""
    return _render(scene, view, proj, cam_pos, cfg, backend, device, False)


def render_with_aux(scene: GaussianData, view, proj, cam_pos,
                    cfg: RenderConfig, backend: Backend = "kernel",
                    device=None):
    """Like render(), also returning {"transmittance": (H, W)} and, for the
    kernel and tile backends, the binning diagnostics num_duplicates /
    overflow / truncated (and, on the kernels with cfg.fused_grad,
    grad_rows_needed / grad_rows_dropped)."""
    return _render(scene, view, proj, cam_pos, cfg, backend, device, True)


def render_camera(scene: GaussianData, camera, cfg: RenderConfig,
                  backend: Backend = "kernel", view=None, cam_pos=None,
                  device=None):
    """render() from a utils.camera.Camera: the free-fly view unless
    ``view`` is given; the camera position is read from the view."""
    if view is None:
        view = camera.get_view_matrix()
    if cam_pos is None:
        cam_pos = np.linalg.inv(np.asarray(view))[:3, 3]
    return render(scene, view, camera.get_project_matrix(), cam_pos, cfg,
                  backend=backend, device=device)
