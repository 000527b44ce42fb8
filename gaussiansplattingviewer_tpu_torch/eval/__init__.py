"""Evaluation: image and depth metrics, disparity tools, packaging,
plots and the cross-backend comparison.

Copies of the JAX package's ``eval/`` modules (the port imports nothing of
that package).  They compute on numpy arrays; scipy, OpenCV and
matplotlib are imported on first use, so importing ``eval`` needs none of
them.  ``compare.compare_backends`` renders through the port.
"""

from gaussiansplattingviewer_tpu_torch.eval.metrics import psnr, ssim, mse
from gaussiansplattingviewer_tpu_torch.eval.lpips_metric import (
    lpips_available,
    lpips_distance,
)
from gaussiansplattingviewer_tpu_torch.eval.blur import blur_effect
from gaussiansplattingviewer_tpu_torch.eval.outliers import remove_statistical_outliers
from gaussiansplattingviewer_tpu_torch.eval.reproject import (
    disparity_to_depth,
    disparity_to_pointcloud,
)
from gaussiansplattingviewer_tpu_torch.eval.sharpen import sharpen_disparity

__all__ = [
    "psnr",
    "ssim",
    "mse",
    "blur_effect",
    "remove_statistical_outliers",
    "disparity_to_depth",
    "disparity_to_pointcloud",
    "sharpen_disparity",
]
