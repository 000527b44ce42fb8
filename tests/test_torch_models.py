"""PyTorch port: scene model, synthetic scenes, host utilities and config
carried across from the JAX package (exact equality throughout)."""

import dataclasses

import numpy as np
import pytest
import torch

import gaussiansplattingviewer_tpu_torch as pt
from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.models import gaussians as jg
from gaussiansplattingviewer_tpu.models import random_scene as jax_random
from gaussiansplattingviewer_tpu.utils import camera as jcam
from gaussiansplattingviewer_tpu.utils import transforms as jtf
from gaussiansplattingviewer_tpu_torch.models import gaussians as pg
from gaussiansplattingviewer_tpu_torch.utils import camera as pcam
from gaussiansplattingviewer_tpu_torch.utils import transforms as ptf
from torch_port_util import port_scene

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")


def assert_same_scene(port, jax_scene):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(port, f).cpu().numpy(), np.asarray(getattr(jax_scene, f)),
            err_msg=f)


def test_naive_gaussian_identical():
    p, pb, pc = pt.naive_gaussian()
    j, jb, jc = jg.naive_gaussian()
    assert_same_scene(p, j)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pc, jc)


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(sh_degree=1, mean_scale=0.04, anisotropy=0.7)),
    (7, dict(sh_degree=0, opacity_mix=True)),
    (5, dict(extent=3.0, mean_scale=0.04, anisotropy=0.7)),
])
def test_random_scene_identical(seed, kw):
    kw = dict(kw)
    deg = kw.pop("sh_degree", 3)
    assert_same_scene(
        pt.random_scene(300, sh_degree=deg, seed=seed, **kw),
        jax_random(300, sh_degree=deg, seed=seed, **kw))


def test_from_numpy_exact_and_padding_helpers():
    j = jax_random(130, sh_degree=2, seed=3).to_device()
    p = port_scene(j)
    assert_same_scene(p, j)
    assert (p.sh_dim, p.sh_degree, len(p)) == (j.sh_dim, j.sh_degree, len(j))
    assert_same_scene(p.pad_to(200), j.pad_to(200))
    assert_same_scene(p.pad_to_multiple(128), j.pad_to_multiple(128))
    assert_same_scene(p.concat(p), j.concat(j))
    idx = np.array([5, 0, 77, 129])
    assert_same_scene(p.select(torch.from_numpy(idx)), j.select(idx))
    np.testing.assert_array_equal(p.flat().numpy(), np.asarray(j.flat()))
    assert_same_scene(pg.GaussianData.from_flat(p.flat(), p.sh_dim), j)
    for a, b in zip(p.aabb(), j.aabb()):
        np.testing.assert_array_equal(a, b)


def test_activations_match():
    rng = np.random.default_rng(0)
    raw = [rng.normal(size=s).astype(np.float32) for s in
           ((50, 3), (50, 1), (50, 4))]
    for a, b in zip(pg.activations(*map(torch.from_numpy, raw)),
                    jg.activations(*raw)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    act = jg.activations(*raw)
    for a, b in zip(pg.inverse_activations(*map(torch.from_numpy, act)),
                    jg.inverse_activations(*act)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_camera_and_transforms_match():
    eye, ctr, up = [0.5, -0.4, 6.0], [0.1, 0.0, -0.2], [0, -1, 0]
    np.testing.assert_array_equal(ptf.look_at(eye, ctr, up),
                                  jtf.look_at(eye, ctr, up))
    np.testing.assert_array_equal(ptf.perspective(1.0, 1.7, 0.1, 100.0),
                                  jtf.perspective(1.0, 1.7, 0.1, 100.0))
    pc, jc = pcam.Camera(h=96, w=160), jcam.Camera(h=96, w=160)
    np.testing.assert_array_equal(pc.get_view_matrix(), jc.get_view_matrix())
    np.testing.assert_array_equal(pc.get_view_matrix(False),
                                  jc.get_view_matrix(False))
    np.testing.assert_array_equal(pc.get_project_matrix(),
                                  jc.get_project_matrix())
    assert pc.get_htanfovxy_focal() == jc.get_htanfovxy_focal()
    rng = np.random.default_rng(1)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_array_equal(ptf.rotate_quat_vec(q, v),
                                  jtf.rotate_quat_vec(q, v))
    np.testing.assert_allclose(ptf.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               jtf.quat_to_rotmat(q), rtol=1e-6, atol=1e-7)


def test_config_carries_across():
    jcfg = JaxConfig(width=200, height=100, mode=JaxMode.FLAT_BALL,
                     background=0.3, tight_culling=False)
    pcfg = pt.RenderConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert isinstance(pcfg.mode, pt.RenderMode)
    assert (pcfg.tiles_x, pcfg.tiles_y, pcfg.num_tiles) == (
        jcfg.tiles_x, jcfg.tiles_y, jcfg.num_tiles)
    assert pt.RenderConfig(**dataclasses.asdict(JaxConfig())) == \
        pt.RenderConfig()
    fused = JaxConfig(fused_grad=True, prefix_rows=512,
                      prefix_budget_rows=8192, residual_budget_rows=4096,
                      grad_budget_rows=9216, grad_residual_budget_rows=2048)
    assert dataclasses.asdict(pt.RenderConfig(**dataclasses.asdict(
        fused))) == dataclasses.asdict(fused)
