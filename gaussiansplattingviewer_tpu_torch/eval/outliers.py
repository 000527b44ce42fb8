"""Statistical outlier removal on point clouds (depth-quality proxy).

Replaces the reference's Open3D ``remove_statistical_outlier`` usage
(metrics/statistical_outlier_removal.py:199-236, nb_neighbors=20,
std_ratio=2.0) with a scipy cKDTree implementation: a point is an outlier
if its mean distance to its k nearest neighbors exceeds
``global_mean + std_ratio * global_std``.

The count of removed points is the reference's depth-quality metric: good
disparity maps back-project to tight surfaces (few outliers), bad ones
spray flying pixels.
"""

from __future__ import annotations

import numpy as np


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0
):
    """Returns (inlier_points, inlier_mask).  Semantics of
    open3d.geometry.PointCloud.remove_statistical_outlier."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    if n <= nb_neighbors:
        return pts, np.ones(n, dtype=bool)
    tree = cKDTree(pts)
    # k+1 because the nearest neighbor of a point is itself
    dists, _ = tree.query(pts, k=nb_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    mask = mean_d <= thresh
    return pts[mask], mask


def outlier_score(points: np.ndarray, nb_neighbors: int = 20,
                  std_ratio: float = 2.0) -> dict:
    """Removed-point count + fraction (the reference's recorded metric,
    metrics/statistical_outlier_removal.py:199-236)."""
    _, mask = remove_statistical_outliers(points, nb_neighbors, std_ratio)
    removed = int((~mask).sum())
    return {
        "n_points": int(len(mask)),
        "n_removed": removed,
        "fraction_removed": removed / max(len(mask), 1),
    }


def disparity_outlier_metric(
    disparity: np.ndarray,
    focal: float,
    baseline: float,
    rgb: np.ndarray | None = None,
    ao_threshold: float | None = None,
    stride: int = 4,
    **kw,
) -> dict:
    """End-to-end depth-quality proxy like the reference's pipeline:
    back-project a disparity map, optionally mask by an alpha/AO threshold
    (metrics/statistical_outlier_removal.py ao-mask thresholds
    0.5/0.75/0.9/None), subsample by ``stride``, and score outliers."""
    from gaussiansplattingviewer_tpu_torch.eval.reproject import (
        disparity_to_pointcloud,
    )

    pts, cols = disparity_to_pointcloud(
        disparity, focal, baseline, rgb=rgb, stride=stride
    )
    if ao_threshold is not None and cols is not None:
        lum = cols.mean(axis=1)
        keep = lum >= ao_threshold
        pts = pts[keep]
    return outlier_score(pts, **kw)
