"""Synthetic random scenes for benchmarks and stress tests.

Numpy ``default_rng`` draws in the same order as the JAX package's
generator, so the same seed gives bit-identical parameters in both.
"""

from __future__ import annotations

import numpy as np

from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData


def random_scene(
    n: int,
    sh_degree: int = 3,
    seed: int = 0,
    extent: float = 4.0,
    mean_scale: float = 0.01,
    anisotropy: float = 0.5,
    opacity_mix: bool = False,
) -> GaussianData:
    """``n`` random Gaussians inside ``[-extent, extent]^3``, on the CPU.

    anisotropy: per-axis log-normal sigma of the scales.
    opacity_mix: bimodal opacities (near-opaque + translucent haze) instead
      of uniform [0.2, 0.9].
    """
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scale = np.exp(
        rng.normal(np.log(mean_scale), anisotropy, size=(n, 3))
    ).astype(np.float32)
    if opacity_mix:
        solid = rng.uniform(size=(n, 1)) < 0.55
        opacity = np.where(
            solid,
            rng.uniform(0.85, 1.0, size=(n, 1)),
            rng.beta(1.2, 3.0, size=(n, 1)),
        ).astype(np.float32)
    else:
        opacity = rng.uniform(0.2, 0.9, size=(n, 1)).astype(np.float32)
    k = 3 * (sh_degree + 1) ** 2
    sh = np.zeros((n, k), dtype=np.float32)
    # DC chosen so colors land roughly in [0,1] after the +0.5 offset
    sh[:, :3] = rng.uniform(-0.5, 0.5, size=(n, 3)) / 0.28209479177387814
    if k > 3:
        sh[:, 3:] = rng.normal(0.0, 0.02, size=(n, k - 3))
    return GaussianData.from_numpy(xyz, rot, scale, opacity, sh)
