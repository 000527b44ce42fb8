"""Visualization / debug utilities for depth and disparity maps.

Covers the reference's loose script drawer (SURVEY.md C21):
  show_depth_image.py     -> normalize_depth_for_display, stereo_shift_check
  normalize_depth.py      -> normalize_depth_for_display (16-bit)
  normalize_image.py      -> colormap_disparity
  radial_undistort.py     -> radial_undistort
  filter_blur_images.py   -> normalize_blur_csv
  plots.py/plot_view_mat.py -> plot_camera_path (matplotlib, optional)
"""

from __future__ import annotations

import csv

import numpy as np


def normalize_depth_for_display(depth16: np.ndarray) -> np.ndarray:
    """Stretch a uint16 depth/disparity map to full 8-bit display range
    (ref normalize_depth.py)."""
    d = np.asarray(depth16, np.float64)
    lo, hi = d.min(), d.max()
    if hi <= lo:
        return np.zeros(d.shape, np.uint8)
    return (255.0 * (d - lo) / (hi - lo)).astype(np.uint8)


def colormap_disparity(disp: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """Map a disparity map to a turbo-like RGB visualization
    (ref normalize_image.py's colormap comparison)."""
    d = np.asarray(disp, np.float64)
    lo, hi = d.min(), d.max()
    t = np.zeros_like(d) if hi <= lo else ((d - lo) / (hi - lo)) ** gamma
    # compact 4-stop jet-ish ramp: blue -> cyan -> yellow -> red
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def stereo_shift_check(
    left: np.ndarray,
    right: np.ndarray,
    disparity_px: np.ndarray,
    points: list[tuple[int, int]] | None = None,
    radius: int = 4,
):
    """The reference's visual sanity check (show_depth_image.py:53-87):
    mark a pixel in the left image and the disparity-shifted location in
    the right image; if the disparity is correct, both marks land on the
    same scene feature.  Returns (left_marked, right_marked)."""
    l = np.ascontiguousarray(np.asarray(left).copy())
    r = np.ascontiguousarray(np.asarray(right).copy())
    h, w = disparity_px.shape[:2]
    if points is None:
        points = [
            (w // 4, h // 2), (w // 2, h // 2), (3 * w // 4, h // 2)
        ]

    def mark(img, x, y, color):
        yy, xx = np.ogrid[:img.shape[0], :img.shape[1]]
        ring = np.abs((yy - y) ** 2 + (xx - x) ** 2 - radius**2) <= radius
        img[ring] = color

    color = np.array([255, 0, 0], dtype=l.dtype) if l.ndim == 3 else 255
    for x, y in points:
        d = float(disparity_px[y, x])
        mark(l, x, y, color)
        xr = int(round(x - d))  # right-image feature sits d pixels left
        if 0 <= xr < w:
            mark(r, xr, y, color)
    return l, r


def radial_undistort(
    image: np.ndarray, k1: float, k2: float = 0.0,
    cx: float | None = None, cy: float | None = None,
) -> np.ndarray:
    """Simple radial (Brown) undistortion with bilinear resampling
    (ref radial_undistort.py's interactive k-slider, as a function)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    if cx is None:
        cx = w / 2.0
    if cy is None:
        cy = h / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - cx) / w
    yn = (ys - cy) / w
    r2 = xn * xn + yn * yn
    factor = 1.0 + k1 * r2 + k2 * r2 * r2
    src_x = np.clip(xn * factor * w + cx, 0, w - 1.001)
    src_y = np.clip(yn * factor * w + cy, 0, h - 1.001)

    x0 = src_x.astype(int)
    y0 = src_y.astype(int)
    fx = (src_x - x0)[..., None] if img.ndim == 3 else src_x - x0
    fy = (src_y - y0)[..., None] if img.ndim == 3 else src_y - y0
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, np.minimum(x0 + 1, w - 1)] * fx * (1 - fy)
        + img[np.minimum(y0 + 1, h - 1), x0] * (1 - fx) * fy
        + img[np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)] * fx * fy
    )
    if np.issubdtype(img.dtype, np.integer):
        out = np.rint(out)
    return out.astype(img.dtype)


def normalize_blur_csv(in_csv: str, out_csv: str) -> None:
    """Min-max normalize the score column of a blur CSV
    (ref filter_blur_images.py)."""
    rows = []
    with open(in_csv) as f:
        for row in csv.reader(f):
            rows.append(row)
    vals = []
    for row in rows:
        try:
            vals.append(float(row[-1]))
        except (ValueError, IndexError):
            vals.append(None)
    nums = [v for v in vals if v is not None]
    lo, hi = (min(nums), max(nums)) if nums else (0.0, 1.0)
    span = (hi - lo) or 1.0
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        for row, v in zip(rows, vals):
            if v is None:
                w.writerow(row)
            else:
                w.writerow(row[:-1] + [f"{(v - lo) / span:.6f}"])


def plot_camera_path(poses, out_png: str) -> None:
    """3D scatter of camera positions + forward vectors (ref plots.py /
    plot_view_mat.py).  Headless (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gaussiansplattingviewer_tpu_torch.utils import colmap as cm

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    pts = []
    for p in poses:
        pos, center, up = cm.colmap_look_at(*p.qvec, *p.tvec)
        pts.append(pos)
        fwd = center - pos
        ax.quiver(*pos, *fwd, length=0.5, color="tab:blue", alpha=0.6)
    pts = np.asarray(pts)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="tab:red", s=8)
    ax.set_title(f"{len(poses)} camera poses")
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
