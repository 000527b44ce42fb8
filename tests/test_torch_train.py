"""PyTorch port: scene I/O round-trips and the trainer against the JAX
package's.

PLY files cross both ways between the JAX ``save_ply`` / ``load_ply``
(numpy path) and the port's, with identical arrays; npz snapshots likewise;
the port's torch train state round-trips.  The trainer: JAX ``train.main``
(tile backend) and the port's ``train.main`` (CPU, plain kernel versions),
both with the f32 fold, run 5 self-distill steps from the same 300-splat
PLY at 64x48.  The first mean loss (before any step) agrees within 1e-6
relative: same scene, same perturbation, same targets up to the blend's
summation order (measured 8.3e-8).  The last agrees within 1e-5 relative,
about ten times the measured 8.7e-7: five Adam steps carry the ~1e-6
gradient differences into the parameters.
"""

import jax
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.models import random_scene as jax_random
from gaussiansplattingviewer_tpu.models.checkpoint import (
    load_npz as jax_load_npz,
)
from gaussiansplattingviewer_tpu.models.checkpoint import (
    save_npz as jax_save_npz,
)
from gaussiansplattingviewer_tpu.models.ply import load_ply as jax_load_ply
from gaussiansplattingviewer_tpu.models.ply import save_ply as jax_save_ply
from gaussiansplattingviewer_tpu_torch.apps import train
from gaussiansplattingviewer_tpu_torch.models import load_ply, save_ply
from gaussiansplattingviewer_tpu_torch.models.checkpoint import (
    load_npz,
    load_train_state,
    save_npz,
    save_train_state,
)
from gaussiansplattingviewer_tpu_torch.utils import colmap
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from torch_port_util import port_scene

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")


def _assert_same(port, jax_scene):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_scene, f)),
                                      err_msg=f)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_round_trips_both_ways(tmp_path, sh_degree):
    scene = jax_random(300, sh_degree=sh_degree, seed=2, extent=1.5,
                       mean_scale=0.05)
    jax_save_ply(scene, tmp_path / "jax.ply")
    port, bbox, center = load_ply(tmp_path / "jax.ply")
    want, j_bbox, j_center = jax_load_ply(tmp_path / "jax.ply",
                                          use_native=False)
    _assert_same(port, want)
    np.testing.assert_array_equal(bbox, j_bbox)
    np.testing.assert_array_equal(center, j_center)

    # the same scene written by each package gives the same bytes
    save_ply(port_scene(scene), tmp_path / "port.ply")
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    # and a loaded scene written by the port reads back alike in both
    save_ply(port, tmp_path / "again.ply")
    back, _, _ = jax_load_ply(tmp_path / "again.ply", use_native=False)
    _assert_same(load_ply(tmp_path / "again.ply")[0], back)


def test_npz_round_trips_both_ways(tmp_path):
    scene = jax_random(200, sh_degree=1, seed=3)
    jax_save_npz(scene, tmp_path / "jax.npz")
    port = load_npz(tmp_path / "jax.npz")
    _assert_same(port, scene)
    save_npz(port, tmp_path / "port.npz")
    _assert_same(port, jax_load_npz(tmp_path / "port.npz"))


def test_train_state_round_trip(tmp_path):
    scene = port_scene(jax_random(50, sh_degree=1, seed=4))
    params = [getattr(scene, f).requires_grad_(True) for f in FIELDS]
    opt = torch.optim.Adam(params, lr=1e-2)
    sum((p * p).sum() for p in params).backward()
    opt.step()
    save_train_state(str(tmp_path), 7, scene, opt)
    back, opt_state, step = load_train_state(str(tmp_path), 7)
    assert step == 7
    for f in FIELDS:
        torch.testing.assert_close(getattr(back, f),
                                   getattr(scene, f).detach(), rtol=0,
                                   atol=0)
    opt2 = torch.optim.Adam([getattr(back, f) for f in FIELDS], lr=1e-2)
    opt2.load_state_dict(opt_state)
    torch.testing.assert_close(opt2.state_dict()["state"][0]["exp_avg"],
                               opt.state_dict()["state"][0]["exp_avg"],
                               rtol=0, atol=0)


def test_colmap_pose_matches_jax():
    from gaussiansplattingviewer_tpu.utils import colmap as jax_colmap

    pose = colmap.ColmapPose(1, np.array([0.9, 0.1, 0.3, -0.2]),
                             np.array([0.2, -0.1, 3.0]), 1, "a.png")
    j_pose = jax_colmap.ColmapPose(1, pose.qvec, pose.tvec, 1, "a.png")
    for got, want in zip(colmap.pose_to_stereo_views(pose),
                         jax_colmap.pose_to_stereo_views(j_pose)):
        np.testing.assert_array_equal(got, want)
    cam = colmap.ColmapCamera(1, "PINHOLE", 640, 480, 500.0, 510.0, 330.0,
                              235.0)
    j_cam = jax_colmap.ColmapCamera(1, "PINHOLE", 640, 480, 500.0, 510.0,
                                    330.0, 235.0)
    np.testing.assert_array_equal(colmap.camera_projection(cam, 96, 64),
                                  jax_colmap.camera_projection(j_cam, 96, 64))
    np.testing.assert_array_equal(tf.translate4(1.0, 2.0, 3.0),
                                  jax_colmap.tf.translate4(1.0, 2.0, 3.0))


def _jax_losses(monkeypatch, argv):
    """Run the JAX trainer, recording every scalar its jitted functions
    return: the first is the initial mean loss, the last the final one."""
    from gaussiansplattingviewer_tpu.apps import train as jax_train

    seen = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)

        def call(*args):
            out = compiled(*args)
            if getattr(out, "ndim", None) == 0:
                seen.append(float(out))
            return out

        return call

    with monkeypatch.context() as m:
        m.setattr(jax, "jit", recording_jit)
        assert jax_train.main(argv + ["--backend", "tile",
                                      "--overflow-check-every", "-1"]) == 0
    return seen[0], seen[-1]


def _port_losses(monkeypatch, argv):
    seen = []
    real = train.mean_loss

    def recording(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(train, "mean_loss", recording)
        assert train.main(argv + ["--device", "cpu"]) == 0
    return seen[0], seen[-1]


def test_trainer_matches_jax(tmp_path, monkeypatch, capsys):
    scene = jax_random(300, sh_degree=1, seed=11, extent=1.5,
                       mean_scale=0.05)
    ply = tmp_path / "scene.ply"
    jax_save_ply(scene, ply)
    argv = ["--gs-model", str(ply), "--self-distill", "--steps", "5",
            "--width", "64", "--height", "48", "--grad-fold-bf16", "off",
            "--log-every", "1000"]
    j_first, j_last = _jax_losses(
        monkeypatch, argv + ["--out", str(tmp_path / "jax.npz")])
    p_first, p_last = _port_losses(
        monkeypatch, argv + ["--out", str(tmp_path / "port.npz"),
                             "--ckpt-dir", str(tmp_path / "ck"),
                             "--ckpt-every", "5"])
    assert p_last < p_first
    np.testing.assert_allclose(p_first, j_first, rtol=1e-6)
    np.testing.assert_allclose(p_last, j_last, rtol=1e-5)
    out = capsys.readouterr()
    assert "final_psnr_db" in out.out and "done: mean loss" in out.err
    trained = load_npz(tmp_path / "port.npz")
    assert len(trained) == 512  # 300 padded to a multiple of 256
    _, _, step = load_train_state(str(tmp_path / "ck"), 5)
    assert step == 5
