"""PyTorch port: the inference blend at tile sizes 8 and 32.

  * The port's render on the CPU (the plain versions of B1 and, on the
    fused serving path, B4 with train=False) against the JAX package's
    Pallas backend in interpret mode, 160x96 at tile 8 and 150x90 at tile
    32, classic and fused, within 1e-5 * max(1, |ref|) where JAX reports
    overflow == truncated == 0.
  * The JAX limit that keeps the fused training kernels (B4 train, B5) at
    tile 16: jax.grad through the Pallas backend fails at tile 8 (the
    train forward's checkpoint is laid out for 256 pixels, and JAX's fused
    path runs only through Pallas); and what lets the classic training
    kernels (B2, B3) take 8 and 32: jax.grad through the tile backend (the
    XLA executor, classic path whatever fused_grad says) succeeds there.
  * The wrappers' tile-size rule for CUDA tensors.
The kernels themselves at 8 and 32 are tests/test_torch_kernels_gpu.py's
(they need the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.ops.render import render as jax_render
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_aux,
)
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.ops import fused
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as b1
from gaussiansplattingviewer_tpu_torch.ops.render import render
from torch_port_util import port_cfg, port_scene

SIZES = [(8, 160, 96), (32, 150, 90)]
# the fused serving path with a residual pass: the scene's tile lists are
# short, so the prefix is 32 rows (as chip_smoke's golden checks)
FUSED = dict(fused_grad=True, prefix_rows=32, residual_budget_rows=1 << 16)


def _setup(cfg):
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.4, -0.3, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    return view, cam.get_project_matrix(), eye


@pytest.mark.parametrize("path", ["classic", "fused"])
@pytest.mark.parametrize("ts,width,height", SIZES)
def test_inference_any_tile_matches_jax_pallas(ts, width, height, path,
                                               monkeypatch):
    cfg = JaxConfig(width=width, height=height, tile_size=ts,
                    **(FUSED if path == "fused" else {}))
    scene = random_scene(2000, sh_degree=3, seed=2, extent=2.5,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg)
    want, aux = jax_render_aux(scene.to_device(), view, proj, eye, cfg,
                               backend="pallas")
    want = np.asarray(want)
    assert int(aux["overflow"]) == 0 and int(aux["truncated"]) == 0
    assert float(np.abs(want).max()) > 0.1

    seeded = []
    orig = fused.tile_raster_fwd_seeded

    def spy(*a, **k):
        seeded.append((a[0].shape[1], k.get("train", False)))
        return orig(*a, **k)

    monkeypatch.setattr(fused, "tile_raster_fwd_seeded", spy)
    got = render(port_scene(scene), view, proj, eye, port_cfg(cfg),
                 device="cpu").numpy()
    assert got.shape == (height, width, 3)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    if path == "fused":
        # the residual pass (B4, inference variant) ran on a non-empty table
        assert len(seeded) == 1 and seeded[0][1] is False
    else:
        assert not seeded


def test_jax_grad_through_pallas_fails_at_tile_8():
    """The parity that keeps B5 and B4 train at 16: JAX's training path
    through Pallas, the only one its fused path has, cannot take another
    tile size."""
    cfg = JaxConfig(width=64, height=48, tile_size=8)
    scene = random_scene(300, sh_degree=1, seed=3, extent=2.0,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg)

    def loss(s):
        return jnp.sum(jax_render(s, view, proj, eye, cfg, backend="pallas"))

    with pytest.raises(Exception, match="reshape"):
        jax.grad(loss)(scene.to_device())


@pytest.mark.parametrize("fused_grad", [False, True])
@pytest.mark.parametrize("ts", [8, 32])
def test_jax_grad_through_tile_backend(ts, fused_grad):
    """The reference trains at tile 8 and 32: jax.grad through the tile
    backend (the classic blend_tiles custom_vjp on the XLA executor, which
    takes the classic path for fused_grad configs too) returns finite,
    nonzero gradients.  B2 and B3 take these sizes on the card for it."""
    cfg = JaxConfig(width=64, height=48, tile_size=ts, fused_grad=fused_grad)
    scene = random_scene(300, sh_degree=1, seed=3, extent=2.0,
                         mean_scale=0.06)
    view, proj, eye = _setup(cfg)

    def loss(s):
        return jnp.sum(jax_render(s, view, proj, eye, cfg, backend="tile")
                       ** 2)

    g = jax.grad(loss)(scene.to_device())
    for f in ("xyz", "rot", "scale", "opacity", "sh"):
        a = np.asarray(getattr(g, f))
        assert np.isfinite(a).all() and np.abs(a).max() > 0, f


@pytest.mark.parametrize("ts", [8, 16, 32, 24])
def test_cuda_tile_size_rule(ts):
    """B1, B2, B3 and B4 inference take 8, 16 and 32 on the card; the
    fused training kernels (B4 train, B5) 16, naming the JAX route that
    limits them; any other size raises for every kernel."""
    cfg = port_cfg(JaxConfig(width=64, height=64, tile_size=ts))
    if ts in (8, 16, 32):
        b1.check_tile_size(cfg)
    else:
        with pytest.raises(ValueError, match="tile_size"):
            b1.check_tile_size(cfg)
    if ts == 16:
        b1.check_tile_size(cfg, fused_train=True)
    elif ts == 24:
        with pytest.raises(ValueError, match="tile_size"):
            b1.check_tile_size(cfg, fused_train=True)
    else:
        with pytest.raises(ValueError, match="raster_tiles.py:68.*256 "
                           "pixels.*tile_raster_fwd.py:334"):
            b1.check_tile_size(cfg, fused_train=True)
