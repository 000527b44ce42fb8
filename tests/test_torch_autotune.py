"""PyTorch port: the autotuner (ops/autotune.py) against the JAX
package's, and the trainer's --autotune loop.

The port's binning is exact, so of the tuned fields only the table budget
and the fused-path fields change what it computes; the pool fields are
still written, because the fused-path decision reads the slot capacity
they describe.  On the same scene and poses the port must return JAX's
RenderConfig field for field.  The scene (opaque, large splats at 96x64)
is one where ``fused=None`` takes the fused path: the probe finds most
listed rows behind saturated pixels.
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.ops import autotune as jat
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.apps import train
from gaussiansplattingviewer_tpu_torch.ops import autotune as pat
from torch_port_util import port_cfg, port_scene


def _setup():
    cfg = JaxConfig(width=96, height=64)
    scene = random_scene(2000, sh_degree=1, seed=3, extent=1.5,
                         mean_scale=0.2)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.0, 0.0, 3.0], np.float32)
    view = np.asarray(tf.look_at(eye, [0, 0, 0], [0, -1, 0]), np.float32)
    return cfg, scene, view, np.asarray(cam.get_project_matrix(),
                                        np.float32), eye


@pytest.mark.parametrize("fused,probe", [(None, True), (True, True),
                                         (False, False)])
def test_autotune_matches_jax(fused, probe):
    cfg, scene, view, proj, eye = _setup()
    want = jat.autotune(scene.to_device(), [view], [proj], [eye], cfg,
                        probe=probe, fused=fused)
    got = pat.autotune(port_scene(scene), [view], [proj], [eye],
                       port_cfg(cfg), probe=probe, fused=fused)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fused_grad == (fused is not False)
    if fused is None:  # the decision itself went the fused way
        assert got.prefix_rows > 0 and got.residual_budget_rows > 0


def test_orbit_autotune_and_overflow_match_jax():
    cfg, scene, _, _, _ = _setup()
    kw = dict(n_azimuth=2, radii_scales=(1.0, 1.5))
    want = jat.autotune_orbit(scene.to_device(), cfg, **kw)
    got = pat.autotune_orbit(port_scene(scene), port_cfg(cfg), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # a budget the scene outgrows: the re-tune trigger fires in both
    _, _, view, proj, eye = _setup()
    tight = cfg.with_(table_budget_rows=1024)
    _, j_trunc = jat.binning_overflow(
        scene.to_device(), jnp.asarray(view), jnp.asarray(proj),
        jnp.asarray(eye), tight)
    ovf, trunc = pat.binning_overflow(port_scene(scene), view, proj, eye,
                                      port_cfg(tight))
    assert int(ovf) == 0 and int(trunc) == int(j_trunc) > 0


def test_train_cli_autotune(tmp_path):
    """apps.train --autotune: tunes before the first step (the table
    budget is the one tuned field it computes with) and polls the
    overflow diagnostic every step."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = train.main(["--self-distill", "--steps", "2", "--width", "64",
                         "--height", "48", "--log-every", "1",
                         "--autotune", "--overflow-check-every", "1",
                         "--device", "cpu",
                         "--out", str(tmp_path / "trained.npz")])
    log = err.getvalue()
    assert rc == 0, log
    assert "# autotuned:" in log and "table_rows=" in log
    assert "final_psnr_db" in out.getvalue()
