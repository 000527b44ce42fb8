from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    GaussianData,
    activations,
    inverse_activations,
    naive_gaussian,
)
from gaussiansplattingviewer_tpu_torch.models.ply import load_ply, save_ply
from gaussiansplattingviewer_tpu_torch.models.random_scene import random_scene

__all__ = [
    "GaussianData",
    "activations",
    "inverse_activations",
    "load_ply",
    "naive_gaussian",
    "random_scene",
    "save_ply",
]
