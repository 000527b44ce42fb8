"""The benchmark's scene, made on the device from the seed.

The distributions are those of the program's synthetic scene generator
(``models/random_scene.py``), drawn here with one ``torch.Generator`` on
the run's device in a few large calls, so set-up moves no scene over the
host link:

  xyz      uniform in [-extent, extent]^3
  rot      normal (w, x, y, z), normalised
  scale    exp(normal(log(mean_scale), anisotropy)) per axis
  opacity  uniform [0.2, 0.9], or with ``opacity_mix`` 55% uniform
           [0.85, 1.0] and the rest Beta(1.2, 3.0)
  sh       DC uniform [-0.5, 0.5] / C0, the other 45 coefficients
           normal(0, 0.02)

then padded to a multiple of ``pad_to`` with inert splats (opacity 0 at the
origin, unit quaternion, scale 1e-9, SH 0), as the program pads.  The same
seed gives the same scene on the same device.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
LEAVES = ("xyz", "rot", "scale", "opacity", "sh")


def make_scene(cfg: dict, seed: int, device) -> dict:
    """{leaf: float32 tensor} of ``cfg['n_splats']`` splats, padded."""
    n, pad_to = cfg["n_splats"], cfg["pad_to"]
    total = -(-n // pad_to) * pad_to
    k = 3 * (cfg["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, **f32) * (hi - lo) + lo

    def normal(shape, mean, std):
        return torch.randn(shape, generator=gen, **f32) * std + mean

    extent = cfg["extent"]
    xyz = uniform((n, 3), -extent, extent)
    rot = normal((n, 4), 0.0, 1.0)
    rot = rot / rot.norm(dim=1, keepdim=True)
    scale = torch.exp(normal((n, 3), math.log(cfg["mean_scale"]),
                             cfg["anisotropy"]))
    if cfg["opacity_mix"]:
        solid = torch.rand((n, 1), generator=gen, **f32) < 0.55
        a = torch._standard_gamma(torch.full((n, 1), 1.2, **f32),
                                  generator=gen)
        b = torch._standard_gamma(torch.full((n, 1), 3.0, **f32),
                                  generator=gen)
        opacity = torch.where(solid, uniform((n, 1), 0.85, 1.0), a / (a + b))
    else:
        opacity = uniform((n, 1), 0.2, 0.9)
    sh = torch.cat([uniform((n, 3), -0.5, 0.5) / SH_C0,
                    normal((n, k - 3), 0.0, 0.02)], dim=1)

    pad = total - n
    fill = {"xyz": [0.0] * 3, "rot": [1.0, 0.0, 0.0, 0.0],
            "scale": [1e-9] * 3, "opacity": [0.0], "sh": [0.0] * k}
    leaves = dict(zip(LEAVES, (xyz, rot, scale, opacity, sh)))
    return {name: torch.cat([a, torch.tensor(fill[name], **f32).expand(
        pad, -1)]) for name, a in leaves.items()}
