"""PyTorch port: gradients of the whole render against the JAX package's.

The port's "kernel" backend (kernel B2 forward, B3 backward, the binning
fold, projection/SH autograd; the plain PyTorch versions on the CPU) is
held against ``jax.grad`` of the JAX ``oracle`` and ``tile`` backends on
tests/test_grads.py's scenes, with its budgets: every field within
1e-5 * max|g| with ``grad_fold_bf16=False`` (both sides run exact f32; only
summation orders differ), 3e-5 against the Pallas kernels (their log-domain
prefix and moment recombination add ~1e-5).  Inputs are made with numpy
and carried across as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.models import naive_gaussian, random_scene
from gaussiansplattingviewer_tpu.ops.projection import project as jax_project
from gaussiansplattingviewer_tpu.ops.render import render as jax_render
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import render
from torch_port_util import port_cfg, port_scene

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")


def _setup(cfg, scene=None):
    if scene is None:
        scene, _, _ = naive_gaussian()
    cam = Camera(h=cfg.height, w=cfg.width)
    view = tf.look_at([0, 0, 3], [0, 0, 0], [0, -1, 0])
    return scene, view, cam.get_project_matrix(), np.array([0, 0, 3.0],
                                                             np.float32)


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.height, cfg.width, 3)).astype(np.float32)


def _jax_grads(scene, view, proj, cam_pos, cfg, backend, weights):
    def loss(sc):
        img = jax_render(sc, view, proj, cam_pos, cfg, backend=backend)
        return jnp.sum(img * jnp.asarray(weights))

    g = jax.grad(loss)(scene.to_device())
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


def _port_grads(scene, view, proj, cam_pos, cfg, weights, backend="kernel"):
    """Gradients of sum(img * weights) through the port on the CPU."""
    sc = port_scene(scene)
    for f in FIELDS:
        getattr(sc, f).requires_grad_(True)
    img = render(sc, view, proj, cam_pos, port_cfg(cfg), backend=backend,
                 device="cpu")
    (img * torch.from_numpy(weights)).sum().backward()
    return _grads(sc)


def _grads(sc):
    """Each leaf's gradient; a leaf the loss does not reach (SH in DEPTH
    mode) has none, which is a zero gradient."""
    return {f: np.zeros(tuple(getattr(sc, f).shape), np.float32)
            if getattr(sc, f).grad is None else getattr(sc, f).grad.numpy()
            for f in FIELDS}


def _assert_fields(got, want, rel, nonzero=()):
    for f in FIELDS:
        scale = np.abs(want[f]).max() + 1e-6
        np.testing.assert_allclose(got[f], want[f], atol=rel * scale,
                                   rtol=0, err_msg=f)
        if f in nonzero:
            assert np.abs(got[f]).max() > 0, f


@pytest.mark.parametrize("mode", [JaxMode.SH0, JaxMode.DEPTH])
def test_kernel_grads_match_jax_naive(mode):
    cfg = JaxConfig(width=96, height=64, mode=mode, grad_fold_bf16=False)
    scene, view, proj, cam_pos = _setup(cfg)
    w = _weights(cfg, 0)
    got = _port_grads(scene, view, proj, cam_pos, cfg, w)
    nonzero = ("xyz", "opacity", "sh", "scale") if mode == JaxMode.SH0 \
        else ("xyz", "opacity")
    for backend in ("oracle", "tile"):
        want = _jax_grads(scene, view, proj, cam_pos, cfg, backend, w)
        _assert_fields(got, want, 1e-5, nonzero)


def test_kernel_grads_match_jax_random():
    cfg = JaxConfig(width=80, height=48, mode=JaxMode.SH3,
                    grad_fold_bf16=False)
    scene = random_scene(300, sh_degree=3, seed=9, extent=2.0,
                         mean_scale=0.06)
    scene, view, proj, cam_pos = _setup(cfg, scene)
    w = _weights(cfg, 1)
    got = _port_grads(scene, view, proj, cam_pos, cfg, w)
    for backend in ("oracle", "tile"):
        want = _jax_grads(scene, view, proj, cam_pos, cfg, backend, w)
        _assert_fields(got, want, 1e-5, FIELDS)


def test_kernel_grads_match_jax_pallas():
    """Parameter level against the JAX Pallas kernels (interpret mode),
    test_grads.py's 3e-5 budget."""
    cfg = JaxConfig(width=64, height=32, mode=JaxMode.SH0,
                    grad_fold_bf16=False)
    scene, view, proj, cam_pos = _setup(cfg)
    w = _weights(cfg, 2)
    got = _port_grads(scene, view, proj, cam_pos, cfg, w)
    want = _jax_grads(scene, view, proj, cam_pos, cfg, "pallas", w)
    _assert_fields(got, want, 3e-5, ("xyz", "opacity", "sh"))


def test_oracle_grads_match_jax_oracle():
    """The port's oracle, differentiated by autograd, is its own ground
    truth for gradients: it must match jax.grad of the JAX oracle."""
    cfg = JaxConfig(width=48, height=32, mode=JaxMode.SH3,
                    grad_fold_bf16=False)
    scene = random_scene(60, sh_degree=3, seed=4, extent=1.5,
                         mean_scale=0.08)
    scene, view, proj, cam_pos = _setup(cfg, scene)
    w = _weights(cfg, 3)
    got = _port_grads(scene, view, proj, cam_pos, cfg, w, backend="oracle")
    want = _jax_grads(scene, view, proj, cam_pos, cfg, "oracle", w)
    _assert_fields(got, want, 1e-5, FIELDS)


@pytest.mark.parametrize("mode", [JaxMode.SH3, JaxMode.DEPTH,
                                  JaxMode.GAUSSIAN_BALL])
def test_projection_grads_match_jax(mode):
    """Projection and SH under autograd against jax.grad of the JAX
    projection, through a loss on every differentiable splat field."""
    cfg = JaxConfig(width=80, height=48, mode=mode)
    scene = random_scene(200, sh_degree=3, seed=11, extent=2.0,
                         mean_scale=0.06)
    scene, view, proj, cam_pos = _setup(cfg, scene)
    rng = np.random.default_rng(12)
    ws = {f: rng.normal(size=s).astype(np.float32) for f, s in (
        ("mean2d", (200, 2)), ("conic", (200, 3)), ("color", (200, 3)),
        ("opacity", (200,)), ("depth", (200,)))}

    def jloss(sc):
        s = jax_project(sc, jnp.asarray(view), jnp.asarray(proj),
                        jnp.asarray(cam_pos), cfg)
        return sum(jnp.sum(jnp.where(s.valid[:, None] if w.ndim == 2
                                     else s.valid, getattr(s, f), 0.0) * w)
                   for f, w in ws.items())

    g = jax.grad(jloss)(scene.to_device())
    want = {f: np.asarray(getattr(g, f)) for f in FIELDS}
    sc = port_scene(scene)
    for f in FIELDS:
        getattr(sc, f).requires_grad_(True)
    s = project(sc, view, proj, cam_pos, port_cfg(cfg))
    loss = 0.0
    for f, w in ws.items():
        v = s.valid[:, None] if w.ndim == 2 else s.valid
        val = torch.where(v, getattr(s, f), torch.zeros(()))
        loss = loss + (val * torch.from_numpy(w)).sum()
    loss.backward()
    got = _grads(sc)
    _assert_fields(got, want, 1e-5)


def test_finite_difference_opacity_and_xyz():
    """Central finite differences on single parameters vs the port's
    kernel-backend gradient (tests/test_grads.py's probes)."""
    cfg = JaxConfig(width=64, height=48, mode=JaxMode.SH0)
    scene, view, proj, cam_pos = _setup(cfg)
    w = _weights(cfg, 5)
    g = _port_grads(scene, view, proj, cam_pos, cfg, w)
    pcfg = port_cfg(cfg)

    def loss(sc):
        with torch.no_grad():
            img = render(sc, view, proj, cam_pos, pcfg, device="cpu")
        return float((img.double() * torch.from_numpy(w).double()).sum())

    for field, idx, eps in [("opacity", (0, 0), 1e-2), ("xyz", (0, 0), 3e-3),
                            ("xyz", (3, 2), 3e-3), ("sh", (0, 0), 1e-2),
                            ("scale", (0, 0), 2e-3)]:
        vals = []
        for sign in (1, -1):
            arr = np.array(getattr(scene, field))
            arr[idx] += sign * eps
            vals.append(loss(port_scene(dataclasses.replace(
                scene, **{field: jnp.asarray(arr)}))))
        numeric = (vals[0] - vals[1]) / (2 * eps)
        analytic = float(g[field][idx])
        assert np.isclose(analytic, numeric, rtol=5e-2, atol=5e-2), (
            field, idx, analytic, numeric)


def test_grad_zero_for_culled_splats():
    cfg = JaxConfig(width=64, height=32)
    scene, view, proj, cam_pos = _setup(cfg)
    xyz = np.array(scene.xyz)
    xyz[1] = [100.0, 0, 0]
    scene = dataclasses.replace(scene, xyz=jnp.asarray(xyz))
    g = _port_grads(scene, view, proj, cam_pos, cfg,
                    np.ones((cfg.height, cfg.width, 3), np.float32))
    np.testing.assert_allclose(g["opacity"][1], 0.0, atol=1e-8)
    np.testing.assert_allclose(g["sh"][1], 0.0, atol=1e-8)
    assert np.abs(g["opacity"]).max() > 0


def test_default_cfg_grads_close_to_f32_fold():
    """The default config rounds each table row's gradient to bf16 before
    the fold (JAX's grad_fold_bf16 semantics); the result stays within
    tests/test_grads.py's envelope of the f32 fold on every field."""
    cfg = JaxConfig(width=96, height=64)
    assert cfg.grad_fold_bf16
    scene = random_scene(2000, sh_degree=1, seed=7, extent=2.0,
                         mean_scale=0.04)
    scene, view, proj, cam_pos = _setup(cfg, scene)
    w = _weights(cfg, 1)
    g16 = _port_grads(scene, view, proj, cam_pos, cfg, w)
    g32 = _port_grads(scene, view, proj, cam_pos,
                      cfg.with_(grad_fold_bf16=False), w)
    budget = {"xyz": 0.005, "rot": 0.015, "scale": 0.025,
              "opacity": 0.005, "sh": 0.008}
    differs = False
    for f in FIELDS:
        scale = np.abs(g32[f]).max() + 1e-6
        np.testing.assert_allclose(g16[f], g32[f], atol=budget[f] * scale,
                                   rtol=0, err_msg=f)
        differs |= bool(np.any(g16[f] != g32[f]))
    assert differs  # the rounding really happened


def test_background_composite_reaches_transmittance():
    """With a background, the loss depends on the final transmittance:
    g_trans is nonzero and the gradient still matches JAX's tile backend."""
    cfg = JaxConfig(width=64, height=48, mode=JaxMode.SH0, background=0.7,
                    grad_fold_bf16=False)
    scene, view, proj, cam_pos = _setup(cfg)
    w = _weights(cfg, 6)
    got = _port_grads(scene, view, proj, cam_pos, cfg, w)
    want = _jax_grads(scene, view, proj, cam_pos, cfg, "tile", w)
    _assert_fields(got, want, 1e-5, ("xyz", "opacity"))
    base = _port_grads(scene, view, proj, cam_pos,
                       cfg.with_(background=0.0), w)
    assert np.abs(base["opacity"] - got["opacity"]).max() > 1e-3


def test_tie_gradients_match_jax():
    """At a tie jnp.maximum / jnp.minimum pass half the gradient to each
    operand.  The port uses torch.maximum / torch.minimum there, not
    torch.clamp, which would pass all of it: the SH colour's clamp at 0 and
    the oracle's alpha clamp, each driven to an exact tie."""
    from gaussiansplattingviewer_tpu.ops.raster_jnp import (
        splat_alpha_color as jax_alpha,
    )
    from gaussiansplattingviewer_tpu.ops.sh import SH_C0
    from gaussiansplattingviewer_tpu.ops.sh import eval_sh_color as jax_sh
    from gaussiansplattingviewer_tpu_torch.ops.raster_oracle import (
        splat_alpha_color,
    )
    from gaussiansplattingviewer_tpu_torch.ops.sh import eval_sh_color

    # a DC coefficient whose colour is exactly 0 after the +0.5 offset
    c0, x = np.float32(SH_C0), np.float32(-0.5 / SH_C0)
    for _ in range(64):
        if np.float32(c0 * x) + np.float32(0.5) == 0:
            break
        x = np.nextafter(x, np.float32(0), dtype=np.float32)
    assert np.float32(c0 * x) + np.float32(0.5) == 0
    sh = np.array([[x, 0.3, -2.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    want = np.asarray(jax.grad(
        lambda s: jnp.sum(jax_sh(s, jnp.asarray(d), 0)))(jnp.asarray(sh)))
    sh_t = torch.from_numpy(sh).requires_grad_(True)
    eval_sh_color(sh_t, torch.from_numpy(d), 0).sum().backward()
    np.testing.assert_allclose(sh_t.grad.numpy(), want, rtol=1e-7)
    assert want[0, 0] == np.float32(0.5) * c0  # the half gradient

    # a splat centred on the pixel at opacity alpha_clamp: alpha == clamp
    cfg = JaxConfig()
    zero = np.zeros((1,), np.float32)
    arrays = dict(conic=np.array([[1.0, 0.0, 1.0]], np.float32),
                  color=np.ones((1, 3), np.float32),
                  radius=np.full((1, 2), 3.0, np.float32))
    op = np.array([cfg.alpha_clamp], np.float32)

    def jloss(o):
        a, _ = jax_alpha(jnp.asarray(zero), jnp.asarray(zero),
                         jnp.asarray(arrays["conic"]), o,
                         jnp.asarray(arrays["color"]),
                         jnp.asarray(arrays["radius"]), cfg)
        return jnp.sum(a)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(op)))
    op_t = torch.from_numpy(op).requires_grad_(True)
    a, _ = splat_alpha_color(
        torch.from_numpy(zero), torch.from_numpy(zero),
        torch.from_numpy(arrays["conic"]), op_t,
        torch.from_numpy(arrays["color"]), torch.from_numpy(arrays["radius"]),
        port_cfg(cfg))
    a.sum().backward()
    np.testing.assert_array_equal(op_t.grad.numpy(), want)
    assert want[0] == 0.5
