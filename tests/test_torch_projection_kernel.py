"""PyTorch port: what the CPU can check of kernels P1 and P2
(``csrc/projection.cu``, ``ops/kernels/projection.py``).

The kernels run only on a card (``tests/test_torch_kernels_gpu.py`` holds
them to the plain ``_project`` there).  Here: CPU tensors take the plain
path and never load the CUDA library, record no kernel counter, and give
``_project``'s bits; the constants written in the CUDA source are the
plain code's; the wrapper refuses what the kernels do not take; the SH
degree is ``eval_sh_color``'s."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import GaussianData, random_scene
from gaussiansplattingviewer_tpu_torch.ops import projection, sh
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
from gaussiansplattingviewer_tpu_torch.ops.kernels import projection as kp
from gaussiansplattingviewer_tpu_torch.utils import profiling
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

PKG = Path(projection.__file__).resolve().parents[1]
LEAVES = ("xyz", "rot", "scale", "opacity", "sh")
FIELDS = ("mean2d", "depth", "conic", "radius", "color", "opacity", "valid")


def _case(mode=RenderMode.SH3):
    cfg = RenderConfig(width=96, height=64, mode=mode)
    scene = random_scene(300, sh_degree=3, seed=4, extent=2.0,
                         mean_scale=0.05)
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 5.0], np.float32)
    return cfg, scene, (tf.look_at(eye, [0, 0, 0], [0, -1, 0]),
                        cam.get_project_matrix(), eye)


def _grads(fn, scene, camera, cfg):
    leaves = [getattr(scene, f).clone().requires_grad_(True) for f in LEAVES]
    out = fn(GaussianData(*leaves), *camera, cfg)
    (out.mean2d.sum() + out.conic.sum() + out.color.sum()
     + out.radius.sum() + out.depth.sum() + out.opacity.sum()).backward()
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("mode", list(RenderMode))
def test_project_on_cpu_runs_plain_code_without_the_library(monkeypatch,
                                                            mode):
    """project() on CPU tensors never loads the CUDA library (its loader
    raises here) and gives ``_project``'s outputs and gradients bit for
    bit."""
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU")

    monkeypatch.setattr(build, "load", refuse)
    cfg, scene, camera = _case(mode)
    got, got_g = _grads(projection.project, scene, camera, cfg)
    want, want_g = _grads(projection._project, scene, camera, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for name, a, b in zip(LEAVES, got_g, want_g):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name


def test_kernel_counter_not_recorded_on_cpu():
    """``project.kernel_splats`` counts kernel forwards only: a recorded
    CPU projection leaves it out, and no launch is counted."""
    cfg, scene, camera = _case()
    launches = kp.project_fwd.launches, kp.project_bwd.launches
    with profiling.collect() as rec:
        _grads(projection.project, scene, camera, cfg)
    assert "project.kernel_splats" not in rec.counts
    assert (kp.project_fwd.launches, kp.project_bwd.launches) == launches


def _cu_constants():
    src = (PKG / "csrc" / "projection.cu").read_text()
    return {m.group(1): np.float32(float(m.group(2))) for m in re.finditer(
        r"constexpr float (\w+) = (-?[0-9.e+-]+)f;", src)}


def test_cuda_source_constants_equal_the_plain_code():
    """The SH constants of ``csrc/projection.cu`` are ``ops/sh.py``'s as
    float32, and its fov clamp, low-pass and divisor floors are the
    literals of ``ops/projection.py``."""
    cu = _cu_constants()
    want = {"SH_C0": sh.SH_C0, "SH_C1": sh.SH_C1}
    want.update({f"SH_C2_{i}": c for i, c in enumerate(sh.SH_C2)})
    want.update({f"SH_C3_{i}": c for i, c in enumerate(sh.SH_C3)})
    plain = (PKG / "ops" / "projection.py").read_text()
    for name, pattern in (
            ("FOV_CLAMP", r"limx = ([0-9.]+) \* tan_fovx"),
            ("LOW_PASS", r"\) \+ ([0-9.]+)\n"),
            ("DIV_EPS", r"torch\.abs\(tz\) < ([0-9.e-]+),"),
            ("NORM_EPS", r"torch\.full_like\(norm, ([0-9.e-]+)\)")):
        want[name] = float(re.search(pattern, plain).group(1))
    assert re.search(r"torch\.abs\(w\) < 1e-8", plain)
    for name, value in want.items():
        assert cu[name] == np.float32(value), name


def _inputs(n=8, k=48):
    return dict(xyz=torch.zeros(n, 3), rot=torch.zeros(n, 4),
                scale=torch.zeros(n, 3), opacity=torch.zeros(n, 1),
                sh=torch.zeros(n, k), view=torch.eye(4), proj=torch.eye(4),
                cam_pos=torch.zeros(3))


@pytest.mark.parametrize("defect,match", [
    ("cpu", "CUDA tensors"),
    ("float64", "float32"),
    ("noncontiguous", "contiguous"),
    ("shape", r"must be \(8, 4\)"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch, defect,
                                                      match):
    """P1's and P2's wrappers raise before any launch (the library is
    never loaded) on CPU tensors, another dtype, a strided leaf or a
    wrong shape."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("loaded"))
    args = _inputs()
    if defect == "float64":
        args["sh"] = args["sh"].double()
    elif defect == "noncontiguous":
        args["xyz"] = torch.zeros(3, 8).T
    elif defect == "shape":
        args["rot"] = torch.zeros(8, 3)
    cfg = RenderConfig()
    with pytest.raises(ValueError, match=match):
        kp.project_fwd(**args, cfg=cfg)
    with pytest.raises(ValueError, match=match):
        kp.project_bwd(**args, cfg=cfg, grads=(None,) * 5)


@pytest.mark.parametrize("width", [3, 12, 27, 48])
def test_sh_degree_is_eval_sh_color_rule(width):
    """``used_degree``, which eval_sh_color and the kernels' wrapper both
    apply, is what the colour reads: min(mode, stored degree, 3), the DC
    band alone in the billboard and ball modes.  Bands past it may hold
    NaN without reaching the colour; the last band it names does reach
    it."""
    stored = {3: 0, 12: 1, 27: 2, 48: 3}[width]
    dirs = torch.nn.functional.normalize(torch.randn(16, 3), dim=-1)
    for mode in RenderMode:
        if mode == RenderMode.DEPTH:
            continue
        deg = sh.used_degree(int(mode), width)
        assert deg == (min(int(mode), stored) if mode >= 0 else 0), mode
        coeffs = torch.randn(16, width)
        coeffs[:, 3 * (deg + 1) ** 2:] = float("nan")
        base = sh.eval_sh_color(coeffs, dirs, int(mode), clamp=False)
        assert torch.isfinite(base).all(), mode
        coeffs[:, 3 * deg ** 2:3 * (deg + 1) ** 2] += 1.0
        moved = sh.eval_sh_color(coeffs, dirs, int(mode), clamp=False)
        assert not torch.equal(base, moved), mode
