"""Scene snapshots and training checkpoints.

  * npz: a single-file scene snapshot written with an atomic rename, the
    same file the JAX package's ``save_npz`` writes;
  * train state: ``torch.save`` of the scene tensors, the optimizer's
    ``state_dict()`` and the step (where the JAX package uses orbax), one
    file per step under a directory.
  * PLY stays the interchange format (models/ply.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.models.gaussians import (
    _FIELDS,
    GaussianData,
)


def save_npz(scene: GaussianData, path: str | os.PathLike) -> None:
    """Atomic single-file snapshot."""
    tmp = str(path) + ".tmp.npz"
    np.savez_compressed(tmp, **{
        f: getattr(scene, f).detach().cpu().numpy() for f in _FIELDS})
    os.replace(tmp, path)


def load_npz(path: str | os.PathLike, device="cpu") -> GaussianData:
    with np.load(path) as z:
        return GaussianData.from_numpy(*(z[f] for f in _FIELDS),
                                       device=device)


def _state_path(ckpt_dir, step: int) -> str:
    return os.path.join(ckpt_dir, f"train_state_{step}.pt")


def save_train_state(ckpt_dir: str, step: int, scene: GaussianData,
                     optimizer: torch.optim.Optimizer | None = None) -> None:
    """Write (scene, optimizer state, step) to ``ckpt_dir`` atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {
        "step": int(step),
        "scene": {f: getattr(scene, f).detach().cpu() for f in _FIELDS},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
    }
    path = _state_path(ckpt_dir, step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_train_state(ckpt_dir: str, step: int, device="cpu"):
    """Restore what save_train_state wrote: (scene on ``device``, the
    optimizer's state dict or None, step).  Load the state dict into an
    optimizer built over the returned scene's tensors."""
    state = torch.load(_state_path(ckpt_dir, step), map_location=device,
                       weights_only=True)
    scene = GaussianData(*(state["scene"][f] for f in _FIELDS))
    return scene, state["optimizer"], state["step"]


def latest_step(ckpt_dir: str) -> int | None:
    """Highest checkpoint step in a directory (resume helper): the step of
    each ``train_state_<step>.pt`` this module writes, and of the JAX
    package's ``scene_<step>.npz`` files and ``<step>`` directories."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        base = name.split(".")[0]
        for prefix in ("train_state_", "scene_"):
            base = base.removeprefix(prefix)
        if base.isdigit():
            steps.append(int(base))
    return max(steps) if steps else None
