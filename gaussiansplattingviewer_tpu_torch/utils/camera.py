"""Camera model: intrinsics, view/projection matrices, and orbit controls.

A numpy copy of the JAX package's ``utils/camera.py`` (the port imports
nothing of that package), with the reference's ``Camera`` (util.py:10-211)
minus the GLFW event plumbing: the orbit/pan/zoom/roll handlers are pure
functions of (dx, dy) deltas so an interactive front-end, a scripted
flythrough, or a test can drive them identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from gaussiansplattingviewer_tpu_torch.utils import transforms as tf

# The reference derives its default vertical fov from a real lens:
# fovy = 2*atan(2088 / (3443.915946 * 2))  (ref util.py:20)
DEFAULT_FOVY = 2.0 * math.atan(2088.0 / (3443.915946 * 2.0))


@dataclass
class Camera:
    """Orbit camera with lazy dirty-flags, mirroring ref util.py:10-211.

    ``h``/``w`` are the render resolution; pose state is the orbit triple
    (position, target, up) plus the free-fly triple (camera_position,
    camera_front, camera_up) the reference uses for its interactive mode
    (util.py:21-27).
    """

    h: int
    w: int
    znear: float = 0.1          # ref util.py:16
    zfar: float = 100.0         # ref util.py:17
    fovy: float = DEFAULT_FOVY  # ref util.py:20

    position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 3.0], dtype=np.float32)
    )
    target: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32)
    )
    # free-fly state (ref util.py:25-27)
    camera_position: np.ndarray = field(
        default_factory=lambda: np.array([-3.0, 0.0, 1.5], dtype=np.float32)
    )
    camera_front: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0], dtype=np.float32)
    )
    camera_up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32)
    )
    yaw: float = -np.pi / 2
    pitch: float = 0.0

    rot_sensitivity: float = 0.02    # ref util.py:42
    trans_sensitivity: float = 0.01  # ref util.py:43
    zoom_sensitivity: float = 0.08   # ref util.py:44
    roll_sensitivity: float = 0.03   # ref util.py:45
    target_dist: float = 3.0         # ref util.py:46

    is_pose_dirty: bool = True
    is_intrin_dirty: bool = True

    # ---- matrices -------------------------------------------------------

    def get_view_matrix(
        self, arcball: bool = True, front=None, pos=None, up=None, view=None
    ) -> np.ndarray:
        """View matrix (math convention: p_view = V @ p_world).

        Argument precedence replicates ref util.py:58-70: an explicit ``view``
        wins; otherwise a supplied (front,pos,up) lookAt; otherwise the
        free-fly state (arcball=True) or the orbit state (arcball=False).
        """
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
        """Perspective projection (ref util.py:82-105 uses its own
        ``perspective`` with hard-coded near 0.1 / far 100)."""
        aspect = self.w / self.h
        return tf.perspective(self.fovy, aspect, 0.1, 100.0)

    def get_htanfovxy_focal(self) -> list[float]:
        """[tan(fovx/2), tan(fovy/2), focal_px] (ref util.py:107-113)."""
        htany = math.tan(self.fovy / 2)
        htanx = htany * (self.w / self.h)
        focal = self.h / (2 * htany)
        return [htanx, htany, focal]

    def get_focal(self) -> float:
        return self.h / (2 * math.tan(self.fovy / 2))

    # ---- controls (pure-math analogues of ref util.py:118-211) ----------

    def orbit(self, dx: float, dy: float) -> None:
        """Orbit around target by mouse deltas (ref util.py:152-164)."""
        self.yaw += dx * self.rot_sensitivity
        self.pitch += dy * self.rot_sensitivity
        self.pitch = float(np.clip(self.pitch, -np.pi / 2, np.pi / 2))
        front = np.array(
            [
                np.cos(self.yaw) * np.cos(self.pitch),
                np.sin(self.pitch),
                np.sin(self.yaw) * np.cos(self.pitch),
            ]
        )
        front = self._global_rot_mat() @ front
        dist = np.linalg.norm(self.position - self.target)
        self.position = (-front * dist + self.target).astype(np.float32)
        self.is_pose_dirty = True

    def _global_rot_mat(self) -> np.ndarray:
        # ref util.py:51-56
        x = np.array([1.0, 0, 0])
        z = np.cross(x, self.up)
        z = z / np.linalg.norm(z)
        x = np.cross(self.up, z)
        return np.stack([x, self.up, z], axis=-1)

    def pan(self, dx: float, dy: float) -> None:
        """Translate both position and target in the view plane."""
        front = tf.normalize(self.target - self.position)
        right = np.cross(self.up, front)
        right = right / np.linalg.norm(right)
        cam_up = np.cross(right, front)
        delta = (
            right * dx * self.trans_sensitivity
            + cam_up * dy * self.trans_sensitivity
        )
        self.position = (self.position + delta).astype(np.float32)
        self.target = (self.target + delta).astype(np.float32)
        self.is_pose_dirty = True

    def zoom(self, dy: float) -> None:
        """Dolly along the view direction (ref util.py:184-190)."""
        front = tf.normalize(self.target - self.position)
        self.position = (
            self.position + front * dy * self.zoom_sensitivity
        ).astype(np.float32)
        self.target = (
            self.target + front * dy * self.zoom_sensitivity
        ).astype(np.float32)
        self.is_pose_dirty = True

    def roll(self, d: float) -> None:
        """Roll the up vector (ref util.py:192-197, Q/E keys)."""
        front = self.target - self.position
        right = np.cross(front, self.up)
        new_up = self.up + right * (
            d * self.roll_sensitivity / np.linalg.norm(right)
        )
        self.up = (new_up / np.linalg.norm(new_up)).astype(np.float32)
        self.is_pose_dirty = True

    def flip_ground(self) -> None:
        """ref util.py:199-201."""
        self.up = -self.up
        self.is_pose_dirty = True

    def update_target_distance(self) -> None:
        """ref util.py:203-206."""
        d = tf.normalize(self.target - self.position)
        self.target = (self.position + d * self.target_dist).astype(np.float32)

    def update_resolution(self, height: int, width: int) -> None:
        self.h = int(height)
        self.w = int(width)
        self.is_intrin_dirty = True


def sphere_orbit_pose(radius: float, theta_deg: float, phi_deg: float,
                      baseline: float = 0.193001):
    """Stereo camera pair on a sphere looking at the origin — the pose
    generator of the reference's experimental fork
    (main_test.py:392-425, generate_sphere_positions): spherical position
    (theta from +z, phi around z), front toward the origin, up (0,-1,0),
    right eye offset ``baseline`` along the right vector.

    Returns (pose_left, pose_right) dicts with camera_front / camera_up /
    camera_position keys, consumable by Camera.get_view_matrix.
    """
    th = math.radians(theta_deg)
    ph = math.radians(phi_deg)
    position = np.array(
        [
            radius * math.sin(th) * math.cos(ph),
            radius * math.sin(th) * math.sin(ph),
            radius * math.cos(th),
        ],
        dtype=np.float32,
    )
    front = -position / max(np.linalg.norm(position), 1e-9)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    right = np.cross(front, up)
    right = right / max(np.linalg.norm(right), 1e-9)
    pose = {
        "camera_front": front.astype(np.float32),
        "camera_up": up,
        "camera_position": position,
        "camera_view": None,
    }
    pose_right = dict(pose)
    pose_right["camera_position"] = (
        position + right * baseline
    ).astype(np.float32)
    return pose, pose_right


def sphere_orbit_path(radius: float, n: int, theta_deg: float = 75.0,
                      baseline: float = 0.193001):
    """n stereo pose pairs sweeping phi around the sphere."""
    return [
        sphere_orbit_pose(radius, theta_deg, 360.0 * i / n, baseline)
        for i in range(n)
    ]
