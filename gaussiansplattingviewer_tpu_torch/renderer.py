"""Stateful renderer with the reference's 8-method interface
(update_gaussian_data, sort_and_update, set_scale_modifier, set_render_mod,
update_camera_pose, update_camera_intrin, draw, set_render_reso).

``sort_and_update`` is a no-op: the tile pipeline sorts inside ``draw``.
``draw`` returns the image as a host numpy array.
"""

from __future__ import annotations

import numpy as np

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops.render import render, resolve_device
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera


class GaussianRenderBase:
    """The reference renderers' interface."""

    def __init__(self):
        self.gaussians = None

    def update_gaussian_data(self, gaus: GaussianData):
        raise NotImplementedError()

    def sort_and_update(self, camera: Camera, use_file=False, pose=None):
        raise NotImplementedError()

    def set_scale_modifier(self, modifier: float):
        raise NotImplementedError()

    def set_render_mod(self, mod: int):
        raise NotImplementedError()

    def update_camera_pose(self, camera: Camera, use_file=False, pose=None):
        raise NotImplementedError()

    def update_camera_intrin(self, camera: Camera):
        raise NotImplementedError()

    def draw(self):
        raise NotImplementedError()

    def set_render_reso(self, w: int, h: int):
        raise NotImplementedError()


class TorchRenderer(GaussianRenderBase):
    """The PyTorch/CUDA backend: renders on ``device`` (default cuda)
    through ``backend`` "kernel", "tile" or "oracle" (ops/render.py)."""

    def __init__(self, w: int, h: int, backend: str = "kernel", device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.backend = backend
        self.cfg = RenderConfig(width=int(w), height=int(h))
        self._view = np.eye(4, dtype=np.float32)
        self._proj = None
        self._cam_pos = np.zeros(3, np.float32)

    def update_gaussian_data(self, gaus: GaussianData):
        self.gaussians = gaus.pad_to_multiple(256).to(self.device)

    def sort_and_update(self, camera: Camera, use_file=False, pose=None):
        return  # sorting happens inside draw()

    def set_scale_modifier(self, modifier: float):
        self.cfg = self.cfg.with_(scale_modifier=float(modifier))

    def set_render_mod(self, mod: int):
        self.cfg = self.cfg.with_(mode=RenderMode(int(mod)))

    def update_camera_pose(self, camera: Camera, use_file=False, pose=None):
        if use_file and pose is not None:
            view = camera.get_view_matrix(
                True,
                pose.get("camera_front"),
                pose.get("camera_position"),
                pose.get("camera_up"),
                pose.get("camera_view"),
            )
            if pose.get("camera_position") is not None:
                camera.position = np.asarray(
                    pose["camera_position"], np.float32)
        else:
            view = camera.get_view_matrix(True)
        self._view = np.asarray(view, np.float32)
        self._cam_pos = np.linalg.inv(self._view)[:3, 3].astype(np.float32)

    def update_camera_intrin(self, camera: Camera):
        self._proj = camera.get_project_matrix()

    def set_render_reso(self, w: int, h: int):
        self.cfg = self.cfg.with_(width=int(w), height=int(h))

    def draw(self) -> np.ndarray:
        """Render the current state -> (H, W, 3) float numpy image."""
        if self.gaussians is None:
            raise RuntimeError("call update_gaussian_data first")
        if self._proj is None:
            self._proj = Camera(h=self.cfg.height,
                                w=self.cfg.width).get_project_matrix()
        img = render(self.gaussians, self._view, self._proj, self._cam_pos,
                     self.cfg, backend=self.backend, device=self.device)
        return img.cpu().numpy()
