"""COLMAP sparse-reconstruction ingestion and pose -> view-matrix conversion.

A numpy copy of the JAX package's ``utils/colmap.py`` (the port imports
nothing of that package): ``images.txt`` / ``cameras.txt`` parsing and the
pose conversion chain ``colmap_look_at`` -> ``look_at`` -> stereo right-eye
translate, with the same constants.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from gaussiansplattingviewer_tpu_torch.utils import transforms as tf


@dataclass(frozen=True)
class ColmapPose:
    """One line of images.txt: IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME
    (ref main.py:614-618)."""

    image_id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


@dataclass(frozen=True)
class ColmapCamera:
    """One line of cameras.txt: ID MODEL W H fx fy cx cy (ref main.py:628-632)."""

    camera_id: int
    model: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


def read_images_txt(path: str | os.PathLike) -> list[ColmapPose]:
    """Parse images.txt, keeping every other line (pose lines; the
    alternating lines hold 2D points) exactly like ref main.py:606-620."""
    poses = []
    line_no = 0
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#"):
                continue
            if line_no % 2 == 1:
                line_no += 1
                continue
            el = line.split()
            if len(el) < 10:
                line_no += 1
                continue
            poses.append(
                ColmapPose(
                    image_id=int(el[0]),
                    qvec=np.array([float(x) for x in el[1:5]], dtype=np.float64),
                    tvec=np.array([float(x) for x in el[5:8]], dtype=np.float64),
                    camera_id=int(el[8]),
                    name=el[9],
                )
            )
            line_no += 1
    return poses


def read_cameras_txt(path: str | os.PathLike) -> list[ColmapCamera]:
    cams = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#"):
                continue
            el = line.split()
            if len(el) < 8:
                continue
            cams.append(
                ColmapCamera(
                    camera_id=int(el[0]),
                    model=el[1],
                    width=int(el[2]),
                    height=int(el[3]),
                    fx=float(el[4]),
                    fy=float(el[5]),
                    cx=float(el[6]),
                    cy=float(el[7]),
                )
            )
    return cams


def load_sparse_dir(sparse_dir: str | os.PathLike):
    """Read a COLMAP sparse/0 directory -> (poses, cameras)."""
    poses = read_images_txt(os.path.join(sparse_dir, "images.txt"))
    cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
    return poses, cams


def camera_projection(
    cam: ColmapCamera,
    render_width: int | None = None,
    render_height: int | None = None,
    znear: float = 0.1,
    zfar: float = 100.0,
) -> np.ndarray:
    """Projection matrix from a COLMAP camera's calibrated intrinsics.

    The reference parses fx/fy/cx/cy (main.py:628-632) and then renders
    with its hard-coded default lens anyway; this uses them.  When the
    render resolution differs from the calibration resolution, the
    intrinsics are rescaled per-axis (fx,cx by W_r/W_c; fy,cy by H_r/H_c)
    so the field of view and principal-point fractions are preserved.
    """
    rw = int(render_width) if render_width else cam.width
    rh = int(render_height) if render_height else cam.height
    sx = rw / float(cam.width)
    sy = rh / float(cam.height)
    return tf.perspective_from_intrinsics(
        cam.fx * sx, cam.fy * sy, cam.cx * sx, cam.cy * sy,
        rw, rh, znear, zfar,
    )


def camera_for_pose(
    cams: list[ColmapCamera], pose: ColmapPose
) -> ColmapCamera | None:
    """The ColmapCamera a pose references (None if absent)."""
    for c in cams:
        if c.camera_id == pose.camera_id:
            return c
    return cams[0] if cams else None


def colmap_look_at(qw, qx, qy, qz, tx, ty, tz):
    """COLMAP pose -> (camera_pos, center_point, world_up).

    Exactly the reference's conversion (main.py:197-215,
    create_look_at_from_colmap): negate the translation for the camera
    position, transpose the quaternion rotation, flip the Z axis for
    handedness, then rotate the OpenGL-space forward (0,0,-1) and up (0,-1,0)
    vectors into world space.
    """
    camera_pos = np.array([-tx, -ty, -tz], dtype=np.float64)
    R = tf.quat_to_rotmat(
        tf.normalize(np.array([qw, qx, qy, qz], dtype=np.float64))
    ).T
    R_flip = R @ np.diag([1.0, 1.0, -1.0])
    world_forward = R_flip @ np.array([0.0, 0.0, -1.0])
    world_up = R_flip @ np.array([0.0, -1.0, 0.0])
    center_point = camera_pos + world_forward
    return camera_pos, center_point, world_up


def pose_to_stereo_views(pose: ColmapPose, baseline: float = -0.5):
    """COLMAP pose -> (left_view, right_view, camera_pos_left, camera_pos_right).

    Left view: lookAtRH from the converted pose (ref main.py:319-321).
    Right view: view-space x translation by ``baseline`` premultiplied onto
    the left view (ref main.py:376-380, T[3,0]=baseline; baseline defaults
    to -0.5 per main.py:280).  Camera position of the right eye is read off
    the inverse view matrix like ref main.py:404.
    """
    qw, qx, qy, qz = pose.qvec
    x, y, z = pose.tvec
    cam_pos, center, up = colmap_look_at(qw, qx, qy, qz, x, y, z)
    view_left = tf.look_at(cam_pos, center, up)
    T = tf.translate4(baseline, 0.0, 0.0)
    view_right = (T @ view_left).astype(np.float32)
    cam_pos_right = np.linalg.inv(view_right)[:3, 3]
    return view_left, view_right, cam_pos.astype(np.float32), cam_pos_right.astype(np.float32)
