"""gaussiansplattingviewer_tpu_torch — the PyTorch/CUDA port of
gaussiansplattingviewer_tpu.

The JAX package beside it is unchanged and remains the reference this port
is tested against.  Entry points render on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import (
    GaussianData,
    naive_gaussian,
    random_scene,
)
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

__all__ = [
    "Camera",
    "GaussianData",
    "RenderConfig",
    "RenderMode",
    "naive_gaussian",
    "random_scene",
]
