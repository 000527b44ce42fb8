"""Image quality metrics: MSE / PSNR / SSIM.

PSNR follows the reference exactly (metrics/psnr_calculation.py:7-14):
``20*log10(255/sqrt(MSE))`` on uint8-range images.  SSIM is the standard
Wang et al. formulation with an 11x1x... gaussian window (the reference
imports skimage's but effectively disables it, main.py:24-31,760 — here it
is a first-class metric).
"""

from __future__ import annotations

import os

import numpy as np


def _to_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float64)
    if img.dtype == np.uint16:
        return img.astype(np.float64) / 257.0  # map to 0..255 range
    img = img.astype(np.float64)
    if img.max() <= 1.0 + 1e-6:
        img = img * 255.0
    return img


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a, b = _to_float(a), _to_float(b)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """ref metrics/psnr_calculation.py:7-14 — returns inf for identical."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(m)))


def ssim(a: np.ndarray, b: np.ndarray, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03, data_range: float = 255.0) -> float:
    """Mean structural similarity (gaussian-weighted, per channel)."""
    from scipy.ndimage import gaussian_filter

    a, b = _to_float(a), _to_float(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = gaussian_filter(x, sigma)
        mu_y = gaussian_filter(y, sigma)
        mu_xx = gaussian_filter(x * x, sigma)
        mu_yy = gaussian_filter(y * y, sigma)
        mu_xy = gaussian_filter(x * y, sigma)
        var_x = mu_xx - mu_x * mu_x
        var_y = mu_yy - mu_y * mu_y
        cov = mu_xy - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def compare_image_dirs(dir_a: str, dir_b: str, metric: str = "psnr") -> dict:
    """Per-scene comparison driver like metrics/psnr_calculation.py:61-95:
    match files by name, return {name: score} plus mean."""
    from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image

    fn = {"psnr": psnr, "ssim": ssim, "mse": mse}[metric]
    names = sorted(
        set(os.listdir(dir_a)) & set(os.listdir(dir_b))
    )
    scores = {}
    for n in names:
        if not n.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        a = read_image(os.path.join(dir_a, n))
        b = read_image(os.path.join(dir_b, n))
        if a.shape != b.shape:
            continue
        scores[n] = fn(a, b)
    finite = [v for v in scores.values() if np.isfinite(v)]
    scores["__mean__"] = float(np.mean(finite)) if finite else float("nan")
    return scores
