"""Host-side camera: intrinsics and view/projection matrices (numpy).

A copy of the JAX package's ``Camera`` matrices; the interactive
orbit/pan/zoom controls arrive with the apps slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from gaussiansplattingviewer_tpu_torch.utils import transforms as tf

# default vertical fov of the reference's lens: 2*atan(2088 / (3443.915946*2))
DEFAULT_FOVY = 2.0 * math.atan(2088.0 / (3443.915946 * 2.0))


@dataclass
class Camera:
    """Camera with the orbit triple (position, target, up) and the
    free-fly triple (camera_position, camera_front, camera_up)."""

    h: int
    w: int
    znear: float = 0.1
    zfar: float = 100.0
    fovy: float = DEFAULT_FOVY

    position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 3.0], dtype=np.float32)
    )
    target: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32)
    )
    camera_position: np.ndarray = field(
        default_factory=lambda: np.array([-3.0, 0.0, 1.5], dtype=np.float32)
    )
    camera_front: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0], dtype=np.float32)
    )
    camera_up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32)
    )

    def get_view_matrix(
        self, arcball: bool = True, front=None, pos=None, up=None, view=None
    ) -> np.ndarray:
        """View matrix (p_view = V @ p_world).  An explicit ``view`` wins;
        otherwise a supplied (front, pos, up) lookAt; otherwise the free-fly
        state (arcball=True) or the orbit state (arcball=False)."""
        if arcball:
            if front is not None:
                if view is not None:
                    return np.asarray(view, dtype=np.float32)
                front = np.asarray(front, dtype=np.float32)
                pos = np.asarray(pos, dtype=np.float32)
                return tf.look_at(pos, pos + front, up)
            return tf.look_at(
                self.camera_position,
                self.camera_position + self.camera_front,
                self.camera_up,
            )
        return tf.look_at(self.position, self.target, self.up)

    def get_project_matrix(self) -> np.ndarray:
        """Perspective projection with near 0.1 / far 100."""
        return tf.perspective(self.fovy, self.w / self.h, 0.1, 100.0)

    def get_htanfovxy_focal(self) -> list[float]:
        """[tan(fovx/2), tan(fovy/2), focal_px]."""
        htany = math.tan(self.fovy / 2)
        htanx = htany * (self.w / self.h)
        return [htanx, htany, self.h / (2 * htany)]
