"""Real spherical-harmonics color evaluation (degrees 0..3).

Same basis and constants as the reference vertex shader and the JAX
package.  Layout: ``sh[..., 3*k : 3*k+3]`` is coefficient k (RGB).
"""

from __future__ import annotations

import torch

# bit-exact constants of the reference shader
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dir: torch.Tensor, degree: int) -> torch.Tensor:
    """SH basis values (..., (degree+1)**2) for unit directions (..., 3).
    Band 1 is (-C1*y, +C1*z, -C1*x)."""
    x, y, z = dir[..., 0], dir[..., 1], dir[..., 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        basis += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(basis, dim=-1)


def used_degree(degree: int, sh_width: int) -> int:
    """The SH degree a colour reads from K = ``sh_width`` interleaved
    coefficients: min(degree, stored degree, 3), where a negative degree
    (the billboard and ball modes) reads the DC band alone."""
    stored_degree = int(round((sh_width // 3) ** 0.5)) - 1
    return min(max(degree, 0), stored_degree, 3)


def eval_sh_color(sh: torch.Tensor, dir: torch.Tensor, degree: int,
                  clamp: bool = True) -> torch.Tensor:
    """RGB (..., 3) from interleaved SH coefficients (..., K) and unit view
    directions (..., 3); bands beyond ``used_degree(degree, K)`` are
    ignored.  ``clamp`` clamps at 0 after the +0.5 offset."""
    deg = used_degree(degree, sh.shape[-1])
    n_coeff = (deg + 1) ** 2
    basis = sh_basis(dir, deg)
    coeffs = sh[..., : 3 * n_coeff].reshape(sh.shape[:-1] + (n_coeff, 3))
    color = torch.einsum("...k,...kc->...c", basis, coeffs) + 0.5
    if clamp:
        # maximum (not clamp): at a tie it passes half the gradient, as
        # jnp.maximum does
        color = torch.maximum(color, torch.zeros_like(color))
    return color
