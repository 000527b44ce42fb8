"""PyTorch port: the host utilities the apps need, against the JAX
package's: the camera controls and orbit paths, rotmat_to_quat,
latest_step and write_disparity16 (to 1e-6 or equal), FrameTimer,
render_stats and trace."""

import json

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.models.checkpoint import (
    latest_step as jax_latest_step,
)
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_aux,
)
from gaussiansplattingviewer_tpu.utils import camera as jax_camera
from gaussiansplattingviewer_tpu.utils import image_io as jax_io
from gaussiansplattingviewer_tpu.utils import profiling as jax_profiling
from gaussiansplattingviewer_tpu.utils import transforms as jax_tf
from gaussiansplattingviewer_tpu_torch.models.checkpoint import latest_step
from gaussiansplattingviewer_tpu_torch.ops.render import render_with_aux
from gaussiansplattingviewer_tpu_torch.utils import camera, image_io, profiling
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from torch_port_util import port_cfg, port_scene

CAMERA_FIELDS = ("h", "w", "fovy", "position", "target", "up",
                 "camera_position", "camera_front", "camera_up", "yaw",
                 "pitch", "target_dist", "is_pose_dirty", "is_intrin_dirty")
MOVES = [("orbit", (3.0, -2.0)), ("pan", (5.0, 1.5)), ("zoom", (-4.0,)),
         ("roll", (2.0,)), ("orbit", (-40.0, 90.0)), ("flip_ground", ()),
         ("update_target_distance", ()), ("zoom", (7.0,)),
         ("update_resolution", (90, 160)), ("pan", (-3.0, 2.0))]


def _same_camera(a, b):
    for f in CAMERA_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64), atol=1e-6,
                                   rtol=0, err_msg=f)


def test_camera_controls_match_jax():
    jc, pc = jax_camera.Camera(h=96, w=128), camera.Camera(h=96, w=128)
    _same_camera(jc, pc)
    for name, args in MOVES:
        getattr(jc, name)(*args)
        getattr(pc, name)(*args)
        _same_camera(jc, pc)
        assert abs(jc.get_focal() - pc.get_focal()) <= 1e-6
        for arcball in (True, False):
            np.testing.assert_allclose(pc.get_view_matrix(arcball),
                                       jc.get_view_matrix(arcball),
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(pc.get_project_matrix(),
                                   jc.get_project_matrix(), atol=1e-6)


@pytest.mark.parametrize("n,theta", [(1, 75.0), (7, 40.0)])
def test_sphere_orbit_path_matches_jax(n, theta):
    got = camera.sphere_orbit_path(2.5, n, theta_deg=theta)
    want = jax_camera.sphere_orbit_path(2.5, n, theta_deg=theta)
    assert len(got) == len(want) == n
    for (gl, gr), (wl, wr) in zip(got, want):
        for g, w in ((gl, wl), (gr, wr)):
            assert g.keys() == w.keys() and g["camera_view"] is None
            for k in ("camera_front", "camera_up", "camera_position"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)


def test_rotmat_to_quat_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for qi in q:
        R = tf.quat_to_rotmat(qi)
        got = tf.rotmat_to_quat(R)
        np.testing.assert_allclose(got, jax_tf.rotmat_to_quat(R), atol=1e-6)
        assert got[0] >= 0
        np.testing.assert_allclose(got, qi * np.sign(qi[0]), atol=1e-6)


def test_latest_step_matches_jax(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None \
        is jax_latest_step(str(tmp_path / "missing"))
    assert latest_step(str(tmp_path)) is None is jax_latest_step(
        str(tmp_path))
    for name in ("100", "scene_200.npz", "scene_x.npz", "notes.txt"):
        (tmp_path / name).mkdir() if name.isdigit() else \
            (tmp_path / name).write_bytes(b"")
    assert latest_step(str(tmp_path)) == jax_latest_step(str(tmp_path)) \
        == 200
    # the port's own train-state files
    (tmp_path / "train_state_300.pt").write_bytes(b"")
    assert latest_step(str(tmp_path)) == 300


def test_write_disparity16_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    disp = rng.uniform(-0.1, 1.1, (23, 41)).astype(np.float32)
    image_io.write_disparity16(tmp_path / "port.png", disp)
    jax_io.write_disparity16(tmp_path / "jax.png", disp)
    got = image_io.read_image(tmp_path / "port.png")
    np.testing.assert_array_equal(got, jax_io.read_image(tmp_path / "jax.png"))
    np.testing.assert_array_equal(
        got, np.clip(disp * 65535.0, 0, 65535).astype(np.uint16))
    image_io.ensure_dirs(tmp_path / "a" / "b", tmp_path / "c")
    assert (tmp_path / "a" / "b").is_dir() and (tmp_path / "c").is_dir()


def test_frame_timer_and_hard_sync():
    calls = []

    def fn():
        calls.append(1)
        return {"img": torch.ones(4, 4), "aux": [torch.zeros(2)]}

    stats = profiling.FrameTimer(fn, pixels=16, splats=8).run(iters=3,
                                                             warmup=2)
    want = jax_profiling.FrameTimer(lambda: np.ones(4), pixels=16,
                                    splats=8).run(iters=3, warmup=2)
    assert stats.keys() == want.keys() and len(calls) == 5
    dt = stats["ms_per_frame"] / 1e3
    assert stats["fps"] == pytest.approx(1.0 / dt)
    assert stats["mpix_s"] == pytest.approx(16 / dt / 1e6)
    assert stats["msplats_s"] == pytest.approx(8 / dt / 1e6)
    profiling.hard_sync(torch.zeros(3))  # CPU tensors: nothing to wait for


def test_render_stats_matches_jax():
    cfg = JaxConfig(width=64, height=48)
    scene = random_scene(400, sh_degree=1, seed=6, extent=1.5,
                         mean_scale=0.05)
    eye = np.array([0.0, 0.0, 3.0], np.float32)
    view = jax_tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = jax_camera.Camera(h=48, w=64).get_project_matrix()
    _, jaux = jax_render_aux(scene.to_device(), view, proj, eye, cfg,
                             backend="tile")
    _, paux = render_with_aux(port_scene(scene), view, proj, eye,
                              port_cfg(cfg), device="cpu")
    got = profiling.render_stats(paux)
    want = jax_profiling.render_stats(jaux)
    assert got.keys() == want.keys() >= {"mean_transmittance",
                                         "num_duplicates"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
