"""Disparity -> depth -> colored point cloud (ref reproject_pc.py).

Geometry identical to the reference (reproject_pc.py:45-49):
``depth = focal * baseline / disparity`` with disparity in PIXELS.  The
dataset generator stores disparity as a fraction of image width x65535
(main.py:876); ``disparity16_to_pixels`` undoes that.
"""

from __future__ import annotations

import numpy as np


def disparity16_to_pixels(disp16: np.ndarray, width: int) -> np.ndarray:
    """uint16 disparity PNG -> disparity in pixels."""
    return np.asarray(disp16, np.float64) / 65535.0 * width


def disparity_to_depth(
    disparity_px: np.ndarray, focal: float, baseline: float,
    min_disparity: float = 1e-6,
) -> np.ndarray:
    """depth = f*B/d (ref reproject_pc.py:45-49); zero/invalid disparity
    maps to depth 0 (dropped by the cloud builder)."""
    d = np.asarray(disparity_px, np.float64)
    valid = d > min_disparity
    depth = np.zeros_like(d)
    depth[valid] = focal * abs(baseline) / d[valid]
    return depth


def disparity_to_pointcloud(
    disparity_px: np.ndarray,
    focal: float,
    baseline: float,
    cx: float | None = None,
    cy: float | None = None,
    rgb: np.ndarray | None = None,
    stride: int = 1,
    max_depth: float | None = None,
):
    """Back-project a disparity map to a 3D point cloud.

    Returns (points (N,3), colors (N,3) or None).  Pinhole model like the
    reference's Open3D RGBD path (reproject_pc.py:72-111).
    """
    h, w = disparity_px.shape[:2]
    if cx is None:
        cx = w / 2.0
    if cy is None:
        cy = h / 2.0
    depth = disparity_to_depth(disparity_px, focal, baseline)

    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    valid = z > 0
    if max_depth is not None:
        valid &= z <= max_depth
    z = z[valid]
    x = (xs[valid] - cx) * z / focal
    y = (ys[valid] - cy) * z / focal
    pts = np.stack([x, y, z], axis=1)

    cols = None
    if rgb is not None:
        rgb_s = np.asarray(rgb)[::stride, ::stride]
        cols = rgb_s[valid].astype(np.float64)
        if cols.max() > 1.0:
            cols = cols / 255.0
    return pts, cols


def save_pointcloud_ply(path, points: np.ndarray, colors: np.ndarray | None = None):
    """Write an xyz[+rgb] binary PLY viewable in standard tools (the
    reference writes via Open3D, reproject_pc.py:104-111)."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    cols_u8 = None
    if colors is not None:
        props += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
        cols_u8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
    header = (
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props
        + ["end_header"]
    )
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if cols_u8 is not None:
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=dtype)
    pts = np.asarray(points, np.float32)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if cols_u8 is not None:
        rec["red"], rec["green"], rec["blue"] = (
            cols_u8[:, 0], cols_u8[:, 1], cols_u8[:, 2],
        )
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
