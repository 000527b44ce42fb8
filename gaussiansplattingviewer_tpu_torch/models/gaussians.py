"""Gaussian scene data model over torch tensors.

Layout (identical to the JAX package and the reference SSBO contract):

  xyz     (N, 3)  float32   world-space means
  rot     (N, 4)  float32   unit quaternions, (w, x, y, z) order
  scale   (N, 3)  float32   per-axis standard deviations (post-exp); (N, 2)
                            for a 2D Gaussian splatting (surfel) scene: the
                            disk's two tangent scales (s_u, s_v)
  opacity (N, 1)  float32   in (0, 1) (post-sigmoid)
  sh      (N, K)  float32   SH coefficients, K = 3 * (deg+1)^2, interleaved
                            per-coefficient RGB: [c0.rgb, c1.rgb, ...]

``GaussianData.from_numpy`` is the carry-across: it takes another package's
leaves as numpy arrays and returns the same parameters as tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = ("xyz", "rot", "scale", "opacity", "sh")


@dataclasses.dataclass
class GaussianData:
    """A Gaussian splatting scene (a dataclass of tensors)."""

    xyz: torch.Tensor
    rot: torch.Tensor
    scale: torch.Tensor
    opacity: torch.Tensor
    sh: torch.Tensor

    def __len__(self) -> int:
        return self.xyz.shape[0]

    @property
    def surfel(self) -> bool:
        """A 2D Gaussian splatting scene: two scales per splat."""
        return self.scale.shape[-1] == 2

    @property
    def sh_dim(self) -> int:
        return self.sh.shape[-1]

    @property
    def sh_degree(self) -> int:
        return int(round((self.sh_dim // 3) ** 0.5)) - 1

    def _map(self, fn) -> "GaussianData":
        return GaussianData(*(fn(getattr(self, f)) for f in _FIELDS))

    @classmethod
    def from_numpy(cls, xyz, rot, scale, opacity, sh,
                   device="cpu") -> "GaussianData":
        """Scene from numpy leaves (e.g. ``np.asarray(jax_scene.xyz)``);
        values are copied exactly as float32."""
        leaves = (xyz, rot, scale, opacity, sh)
        return cls(*(
            torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for a in leaves
        ))

    def to(self, device) -> "GaussianData":
        return self._map(lambda a: a.to(device))

    def flat(self) -> torch.Tensor:
        """(N, 11 + sh_dim) row-major — the reference SSBO layout; a surfel
        scene's rows are one scale narrower, (N, 10 + sh_dim)."""
        return torch.cat(
            [self.xyz, self.rot, self.scale, self.opacity, self.sh], dim=-1
        ).contiguous()

    @classmethod
    def from_flat(cls, flat: torch.Tensor, sh_dim: int) -> "GaussianData":
        """The inverse of ``flat``: 3 scales at width 11 + sh_dim, 2 (a
        surfel scene) at 10 + sh_dim."""
        n_scale = flat.shape[-1] - 8 - sh_dim
        if n_scale not in (2, 3):
            raise ValueError(f"flat width {flat.shape[-1]} is neither 11 + "
                             f"{sh_dim} nor 10 + {sh_dim}")
        s1 = 7 + n_scale
        return cls(
            xyz=flat[:, 0:3],
            rot=flat[:, 3:7],
            scale=flat[:, 7:s1],
            opacity=flat[:, s1:s1 + 1],
            sh=flat[:, s1 + 1:],
        )

    def pad_to(self, n: int) -> "GaussianData":
        """Pad to exactly ``n`` Gaussians with inert splats (opacity 0, at
        the origin, unit quaternion, tiny scale)."""
        cur = len(self)
        if cur == n:
            return self
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than current {cur}")
        pad = n - cur

        def _pad(a, fill_row):
            filler = torch.tensor(fill_row, dtype=a.dtype, device=a.device)
            return torch.cat([a, filler[None, :].expand(pad, -1)], dim=0)

        return GaussianData(
            xyz=_pad(self.xyz, [0.0, 0.0, 0.0]),
            rot=_pad(self.rot, [1.0, 0.0, 0.0, 0.0]),
            scale=_pad(self.scale, [1e-9] * self.scale.shape[-1]),
            opacity=_pad(self.opacity, [0.0]),
            sh=_pad(self.sh, [0.0] * self.sh_dim),
        )

    def pad_to_multiple(self, m: int = 128) -> "GaussianData":
        n = len(self)
        return self.pad_to(-(-n // m) * m)

    def concat(self, other: "GaussianData") -> "GaussianData":
        if self.sh_dim != other.sh_dim:
            raise ValueError("concat needs equal sh_dim")
        if self.scale.shape[-1] != other.scale.shape[-1]:
            raise ValueError(
                f"concat needs one primitive: {self.scale.shape[-1]} and "
                f"{other.scale.shape[-1]} scales per splat (3DGS has 3, a "
                f"2DGS surfel 2)")
        return GaussianData(*(
            torch.cat([getattr(self, f), getattr(other, f)], dim=0)
            for f in _FIELDS
        ))

    def select(self, idx) -> "GaussianData":
        return self._map(lambda a: a[idx])

    def aabb(self):
        """Axis-aligned bounding box (2, 3) and centroid (3,), numpy."""
        xyz = self.xyz.detach().cpu().numpy()
        bbox = np.stack([xyz.min(axis=0), xyz.max(axis=0)])
        return bbox, xyz.mean(axis=0)


def naive_gaussian() -> tuple[GaussianData, np.ndarray, np.ndarray]:
    """The 4-splat synthetic smoke-test scene: an isotropic magenta splat at
    the origin plus red/green/blue splats elongated along +x/+y/+z.

    Returns (scene on the CPU, bbox, center)."""
    xyz = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32
    )
    rot = np.tile(np.array([1, 0, 0, 0], dtype=np.float32), (4, 1))
    scale = np.array(
        [
            [0.03, 0.03, 0.03],
            [0.2, 0.03, 0.03],
            [0.03, 0.2, 0.03],
            [0.03, 0.03, 0.2],
        ],
        dtype=np.float32,
    )
    rgb = np.array(
        [[1, 0, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32
    )
    sh_dc = (rgb - 0.5) / 0.28209  # the reference's own constant
    opacity = np.ones((4, 1), dtype=np.float32)
    scene = GaussianData.from_numpy(xyz, rot, scale, opacity, sh_dc)
    bbox, center = scene.aabb()
    return scene, bbox, center


def activations(raw_scale, raw_opacity, raw_rot):
    """exp on scales, sigmoid on opacity, L2-normalize on quaternions."""
    scale = torch.exp(raw_scale)
    opacity = 1.0 / (1.0 + torch.exp(-raw_opacity))
    rot = raw_rot / torch.linalg.norm(raw_rot, dim=-1, keepdim=True)
    return scale, opacity, rot


def inverse_activations(scale, opacity, rot):
    """Inverse of ``activations``."""
    raw_scale = torch.log(torch.clamp(scale, min=1e-12))
    op = torch.clamp(opacity, 1e-12, 1.0 - 1e-7)
    raw_opacity = torch.log(op) - torch.log1p(-op)
    return raw_scale, raw_opacity, rot
