"""Camera traffic from a mix file: an orbit of poses around the
configuration's target at its eye's distance and height.

Pose i of P looks at the target from the eye turned by 2 pi i / P about
the vertical axis, with the program's camera conventions (a right-handed
look-at with up (0, -1, 0), and the OpenGL perspective at the
configuration's fovy, near 0.1 and far 100, as the program's ``Camera``
builds it).  The matrices are made on the run's device once, in set-up;
the program receives them as tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    return view


def perspective(fovy, aspect, near=0.1, far=100.0) -> np.ndarray:
    f = 1.0 / math.tan(fovy / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / aspect, f
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    return proj


def orbit(config: dict, poses: int, device):
    """``poses`` (view, proj, cam_pos) float32 tensors on ``device``."""
    eye = np.asarray(config["eye"], np.float64)
    target = np.asarray(config["target"], np.float64)
    rel = eye - target
    proj = torch.tensor(perspective(config["fovy"], config["width"]
                                    / config["height"]), dtype=torch.float32,
                        device=device)
    out = []
    for i in range(poses):
        a = 2.0 * math.pi * i / poses
        c, s = math.cos(a), math.sin(a)
        e = target + np.array([c * rel[0] + s * rel[2], rel[1],
                               -s * rel[0] + c * rel[2]])
        view, cam = (torch.tensor(m, dtype=torch.float32, device=device)
                     for m in (look_at(e, target), e))
        out.append((view, proj, cam))
    return out


def spread(count: int, total: int) -> list[int]:
    """``count`` indices spread evenly over range(total)."""
    return sorted({int(i * total / count) for i in range(count)})
