"""PyTorch port, the whole serving slice: project -> bin -> tile blend.

Against JAX render(backend="pallas") within atol=2e-4 (the oracle-vs-Pallas
budget of tests/test_pallas.py), and against the stored goldens at their
own budgets (tests/test_golden.py)."""

import os

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.models import naive_gaussian as jax_naive
from gaussiansplattingviewer_tpu.models import random_scene as jax_random
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_with_aux,
)
from gaussiansplattingviewer_tpu_torch import naive_gaussian, random_scene
from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_camera,
    render_with_aux,
)
from gaussiansplattingviewer_tpu_torch.renderer import TorchRenderer
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
from torch_port_util import port_cfg, port_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _front(cfg):
    cam = Camera(h=cfg.height, w=cfg.width)
    view = tf.look_at([0, 0, 3], [0, 0, 0], [0, -1, 0])
    return view, cam.get_project_matrix(), np.array([0, 0, 3.0], np.float32)


@pytest.mark.parametrize("case", ["naive", "random600"])
def test_render_matches_jax_pallas(case):
    if case == "naive":
        jcfg = JaxConfig(width=96, height=64, background=0.2)
        jscene = jax_naive()[0].to_device()
    else:
        jcfg = JaxConfig(width=96, height=64)
        jscene = jax_random(600, sh_degree=2, seed=21, extent=2.0,
                            mean_scale=0.06).to_device()
    view, proj, eye = _front(jcfg)
    want, want_aux = jax_render_with_aux(jscene, view, proj, eye, jcfg,
                                         backend="pallas")
    got, aux = render_with_aux(port_scene(jscene), view, proj, eye,
                               port_cfg(jcfg), device="cpu")
    assert got.shape == (64, 96, 3) and got.dtype == torch.float32
    assert float(got.max()) > 0.05
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(aux["transmittance"].numpy(),
                               np.asarray(want_aux["transmittance"]),
                               atol=2e-4)
    for key in ("num_duplicates", "overflow", "truncated"):
        assert int(aux[key]) == int(want_aux[key]), key


def test_oracle_matches_kernel_path():
    cfg = RenderConfig(width=96, height=64, debug=True)
    scene = random_scene(400, sh_degree=1, seed=17, extent=2.0,
                         mean_scale=0.06)
    view, proj, eye = _front(cfg)
    tile, aux = render_with_aux(scene, view, proj, eye, cfg, device="cpu")
    oracle = render(scene, view, proj, eye, cfg, backend="oracle",
                    device="cpu")
    np.testing.assert_allclose(tile.numpy(), oracle.numpy(), atol=1e-4)
    assert int(aux["nonfinite_splats"]) == 0
    assert int(aux["nonfinite_pixels"]) == 0


@pytest.mark.parametrize("mode", [RenderMode.SH0, RenderMode.DEPTH])
def test_golden_naive(mode):
    cfg = RenderConfig(width=128, height=96, mode=mode, background=0.1)
    scene, _, _ = naive_gaussian()
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = [0.8, -0.5, 2.5]
    view = tf.look_at(eye, [0.2, 0.2, 0.2], [0, -1, 0])
    img = render(scene, view, cam.get_project_matrix(),
                 np.array(eye, np.float32), cfg, device="cpu").numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, f"naive_{int(mode)}.npz"))[
        "img"].astype(np.float32)
    np.testing.assert_allclose(img, golden, atol=2e-3)


_REF = {}


def _ref_scene():
    if "scene" not in _REF:
        _REF["scene"] = random_scene(
            10_000, sh_degree=3, seed=5, extent=3.0, mean_scale=0.04,
            anisotropy=0.7,
        ).pad_to_multiple(1024)
    return _REF["scene"]


@pytest.mark.parametrize("mode", [
    RenderMode.SH1, RenderMode.SH2, RenderMode.SH3, RenderMode.DEPTH,
    RenderMode.BILLBOARD, RenderMode.FLAT_BALL, RenderMode.GAUSSIAN_BALL,
])
def test_golden_refres_modes(mode):
    cfg = RenderConfig(width=1160, height=522, mode=mode)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.5, -0.4, 6.0])
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    img = render(_ref_scene(), view, cam.get_project_matrix(),
                 eye.astype(np.float32), cfg, device="cpu").numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, f"refres10k_{int(mode)}.npz"))[
        "img"].astype(np.float32)
    atol = 2e-3 * max(1.0, float(np.abs(golden).max()))
    np.testing.assert_allclose(img, golden, atol=atol, err_msg=str(mode))
    assert img.sum() > 0.0


def test_no_cpu_fallback(monkeypatch):
    """Without a card, entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _, _ = naive_gaussian()
    cfg = RenderConfig(width=32, height=32)
    view, proj, eye = _front(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(scene, view, proj, eye, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_with_aux(scene, view, proj, eye, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_camera(scene, Camera(h=32, w=32), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRenderer(32, 32)


def test_render_refuses_gradients():
    """render() is differentiable since the training slice: a scene leaf
    that requires grad gets a finite, nonzero gradient; under no_grad the
    image carries no graph (the inference path)."""
    scene, _, _ = naive_gaussian()
    scene.xyz.requires_grad_(True)
    cfg = RenderConfig(width=32, height=32)
    view, proj, eye = _front(cfg)
    with torch.no_grad():
        assert not render(scene, view, proj, eye, cfg,
                          device="cpu").requires_grad
    img = render(scene, view, proj, eye, cfg, device="cpu")
    (img * img).sum().backward()
    assert torch.isfinite(scene.xyz.grad).all()
    assert float(scene.xyz.grad.abs().max()) > 0


def test_renderer_interface():
    r = TorchRenderer(96, 64, device="cpu")
    r.update_gaussian_data(naive_gaussian()[0])
    assert len(r.gaussians) == 256
    cam = Camera(h=64, w=96)
    cam.camera_position = np.array([0.0, 0.0, 3.0], np.float32)
    r.update_camera_pose(cam)
    r.update_camera_intrin(cam)
    r.set_render_mod(int(RenderMode.SH0))
    r.set_scale_modifier(1.0)
    r.sort_and_update(cam)
    img = r.draw()
    assert img.shape == (64, 96, 3) and img.max() > 0.1
    want = render_camera(naive_gaussian()[0], cam,
                         RenderConfig(width=96, height=64,
                                      mode=RenderMode.SH0), device="cpu")
    np.testing.assert_array_equal(img, want.numpy())
    r.set_render_reso(48, 32)
    assert r.draw().shape == (32, 48, 3)
