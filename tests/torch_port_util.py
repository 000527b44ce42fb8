"""Helpers shared by the tests that hold the PyTorch port
(gaussiansplattingviewer_tpu_torch) against the JAX package: inputs are
made with numpy and carried across as numpy arrays."""

import dataclasses

import numpy as np
import torch

import gaussiansplattingviewer_tpu_torch as pt
from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.ops.projection import (
    ProjectedSplats as JaxSplats,
)
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats

SPLAT_FIELDS = ("mean2d", "depth", "conic", "radius", "color", "opacity",
                "valid")


def port_cfg(jax_cfg: JaxConfig) -> pt.RenderConfig:
    return pt.RenderConfig(**dataclasses.asdict(jax_cfg))


def port_scene(jax_scene, device="cpu") -> pt.GaussianData:
    """The port's scene with exactly the JAX scene's parameters."""
    return pt.GaussianData.from_numpy(
        *(np.asarray(getattr(jax_scene, f))
          for f in ("xyz", "rot", "scale", "opacity", "sh")),
        device=device,
    )


def splats_numpy(splats) -> dict:
    """Fields of either package's ProjectedSplats as numpy arrays."""
    out = {}
    for f in SPLAT_FIELDS:
        a = getattr(splats, f)
        out[f] = a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    return out


def both_splats(arrays: dict):
    """(JAX ProjectedSplats, port ProjectedSplats) of the same numpy
    fields."""
    import jax.numpy as jnp

    jax_s = JaxSplats(**{k: jnp.asarray(arrays[k]) for k in SPLAT_FIELDS})
    return jax_s, ProjectedSplats.from_numpy(**arrays)


def synthetic_splats(n, width, height, seed, centre=None, spread=None,
                     scale=(1.0, 6.0), opacity=(0.2, 0.9)) -> dict:
    """Projected splats made directly with numpy: positive-definite conics,
    3-sigma radii, distinct positive depths, all valid."""
    rng = np.random.default_rng(seed)
    if centre is None:
        centre, spread = (width / 2, height / 2), (width / 2, height / 2)
    mean2d = np.stack([
        rng.uniform(centre[0] - spread[0], centre[0] + spread[0], n),
        rng.uniform(centre[1] - spread[1], centre[1] + spread[1], n),
    ], axis=1)
    sx = rng.uniform(*scale, n)
    sy = rng.uniform(*scale, n)
    rho = rng.uniform(-0.6, 0.6, n)
    cxx, cyy, cxy = sx * sx + 0.3, sy * sy + 0.3, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    f32 = np.float32
    return dict(
        mean2d=mean2d.astype(f32),
        depth=rng.uniform(1.0, 10.0, n).astype(f32),
        conic=np.stack([cyy / det, cxy / det, cxx / det], 1).astype(f32),
        radius=np.stack([3 * np.sqrt(cxx), 3 * np.sqrt(cyy)], 1).astype(f32),
        color=rng.uniform(0.0, 1.0, (n, 3)).astype(f32),
        opacity=rng.uniform(*opacity, n).astype(f32),
        valid=np.ones(n, bool),
    )
