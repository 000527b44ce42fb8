"""Quaternion / matrix helpers: numpy on the host, torch for the scene.

Conventions (the same as the JAX package):
  * Matrices are math matrices: ``p_view = V @ p_world`` with column vectors.
  * Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rotmat(q):
    """Unit quaternions (..., 4) (w,x,y,z) -> rotation matrices (..., 3, 3);
    a tensor gives a tensor, a numpy array a numpy array."""
    if isinstance(q, torch.Tensor):
        stack = torch.stack
    else:
        def stack(xs, dim):
            return np.stack(xs, axis=dim)
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
        stack([r00, r01, r02], -1),
        stack([r10, r11, r12], -1),
        stack([r20, r21, r22], -1),
    ]
    return stack(rows, -2)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (w,x,y,z), w >= 0.

    Eigen-decomposition method, as the reference's rotmat2qvec (main.py:
    115-126), which unpacks R.flat row by row, i.e. Ryx = R[0,1]."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    q = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if q[0] < 0:
        q = -q
    return q


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


def perspective_from_intrinsics(
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, near: float = 0.1, far: float = 100.0,
) -> np.ndarray:
    """OpenGL-convention projection from pinhole intrinsics (COLMAP
    cameras.txt fx/fy/cx/cy), for the y-down pixel frame the projection
    uses: P00 = 2fx/W, P02 = 1 - 2cx/W, P11 = 2fy/H, P12 = 2cy/H - 1.  A
    centred principal point reduces it to ``perspective``."""
    W, H = float(width), float(height)
    P = np.zeros((4, 4))
    P[0, 0] = 2.0 * fx / W
    P[0, 2] = 1.0 - 2.0 * cx / W
    P[1, 1] = 2.0 * fy / H
    P[1, 2] = 2.0 * cy / H - 1.0
    P[2, 2] = -(far + near) / (far - near)
    P[2, 3] = -(2.0 * far * near) / (far - near)
    P[3, 2] = -1.0
    return P.astype(np.float32)


def translate4(tx: float, ty: float, tz: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[1, 3], T[2, 3] = tx, ty, tz
    return T


def rotate_quat_vec(q, v):
    """Rotate vector(s) v by quaternion(s) q (w,x,y,z)."""
    qv = q[..., 1:]
    w = q[..., 0]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (w[..., None] * uv + uuv)
