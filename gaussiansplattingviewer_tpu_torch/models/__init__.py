from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    GaussianData,
    activations,
    inverse_activations,
    naive_gaussian,
)
from gaussiansplattingviewer_tpu_torch.models.random_scene import random_scene

__all__ = [
    "GaussianData",
    "activations",
    "inverse_activations",
    "naive_gaussian",
    "random_scene",
]
