"""Perceptual blur metric (Crete et al. 2007).

Drop-in replacement for ``skimage.measure.blur_effect`` as used by the
reference's blur pipeline (metrics/blur_calculation.py:86-97, h_size=11;
main.py:777 h_size=11 / main.py:907 h_size=23): re-blur the image strongly
along each axis and measure how much neighbor variation survives — sharp
images lose a lot (score -> 0 means sharp, -> 1 means already blurred).
"""

from __future__ import annotations

import numpy as np


def blur_effect(image: np.ndarray, h_size: int = 11) -> float:
    """Blur metric in [0, 1]; 0 = sharp, 1 = maximally blurry."""
    from scipy.ndimage import uniform_filter1d

    im = np.asarray(image, dtype=np.float64)
    if im.ndim == 3:  # luminance like skimage (rgb2gray weights)
        im = im @ np.array([0.2125, 0.7154, 0.0721])
    if im.max() > 1.0:
        im = im / 255.0

    scores = []
    for axis in (0, 1):
        blurred = uniform_filter1d(im, size=h_size, axis=axis)
        d_orig = np.abs(np.diff(im, axis=axis))
        d_blur = np.abs(np.diff(blurred, axis=axis))
        t = np.maximum(0.0, d_orig - d_blur)
        m1 = d_orig.sum()
        m2 = t.sum()
        scores.append(abs(m1 - m2) / m1 if m1 > 0 else 0.0)
    return float(max(scores))


def blur_scores_for_dir(path: str, h_size: int = 11,
                        max_black_frac: float = 0.005) -> dict:
    """Per-image blur scores like metrics/blur_calculation.py:86-138:
    skip frames with more than ``max_black_frac`` black pixels (capture
    artifacts), return {name: score} plus moving statistics."""
    import os

    from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image

    scores = {}
    for name in sorted(os.listdir(path)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = read_image(os.path.join(path, name))
        gray = img if img.ndim == 2 else img.mean(axis=-1)
        if (gray == 0).mean() > max_black_frac:
            continue  # ref metrics/blur_calculation.py:86-97
        scores[name] = blur_effect(img, h_size=h_size)
    vals = list(scores.values())
    if vals:
        scores["__mean__"] = float(np.mean(vals))
        scores["__median__"] = float(np.median(vals))
    return scores
