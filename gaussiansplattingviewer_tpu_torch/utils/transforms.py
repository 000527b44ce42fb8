"""Quaternion / matrix helpers: numpy on the host, torch for the scene.

Conventions (the same as the JAX package):
  * Matrices are math matrices: ``p_view = V @ p_world`` with column vectors.
  * Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) (w,x,y,z) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def normalize(v, axis=-1, eps: float = 0.0):
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = np.maximum(n, eps)
    return v / n


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed lookAt view matrix (rows: right, up', -forward;
    translation -R @ eye)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = normalize(center - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    V = np.eye(4)
    V[0, :3] = s
    V[1, :3] = u
    V[2, :3] = -f
    V[:3, 3] = -V[:3, :3] @ eye
    return V.astype(np.float32)


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL-convention right-handed perspective projection matrix."""
    f = 1.0 / np.tan(fovy / 2.0)
    P = np.zeros((4, 4))
    P[0, 0] = f / aspect
    P[1, 1] = f
    P[2, 2] = -(far + near) / (far - near)
    P[2, 3] = -(2.0 * far * near) / (far - near)
    P[3, 2] = -1.0
    return P.astype(np.float32)


def rotate_quat_vec(q, v):
    """Rotate vector(s) v by quaternion(s) q (w,x,y,z)."""
    qv = q[..., 1:]
    w = q[..., 0]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (w[..., None] * uv + uuv)
