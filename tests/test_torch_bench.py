"""PyTorch port: the benchmark (``gaussiansplattingviewer_tpu_torch.bench``,
the port of ``bench.py``) on the CPU at a tiny size.

Its JSON line carries ``bench.py``'s keys (read from ``bench.py``'s own
source) and the port's four; the parity check's outcome sets
``parity_pass`` and the exit code; ``--forward-only`` and ``--no-fuse``
run; without a card ``--device cuda`` (and every other new entry point)
exits non-zero.  The training step itself, on the bench's scene and
camera, matches JAX's ``value_and_grad`` of sum(img^2) through its
``tile`` backend: the loss within 1e-5 relative, each field's gradient
within 1e-5 * max|g| with ``grad_fold_bf16=False`` (tests/test_grads.py's
budget), on a scene where JAX reports no overflow or truncation.
"""

import ast
import json
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.models import random_scene as jax_scene
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_with_aux,
)
from gaussiansplattingviewer_tpu.utils import transforms as jtf
from gaussiansplattingviewer_tpu.utils.camera import Camera as JaxCamera
from gaussiansplattingviewer_tpu_torch import bench
from gaussiansplattingviewer_tpu_torch.eval import ply_roundtrip, scaling
from gaussiansplattingviewer_tpu_torch.models import GaussianData
from torch_port_util import port_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
TINY = ["--n-splats", "2000", "--width", "96", "--height", "64",
        "--iters", "2", "--warmup", "1", "--device", "cpu"]
NEW_KEYS = {"card", "ms_step", "device_ms_step", "busy"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test, restored after it: the harnesses'
    many small ops under the suite's parallel workers otherwise spend 30
    to 60 times as long waiting on the thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench_keys():
    """Every key bench.py puts in its JSON line: the ``result`` dict
    literal's keys and each ``result["..."] =`` assignment."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "result" \
                        and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if isinstance(t, ast.Subscript) and getattr(
                        t.value, "id", None) == "result":
                    keys.add(t.slice.value)
    return keys


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_jax_bench_keys_are_read():
    assert _jax_bench_keys() == {
        "metric", "value", "unit", "vs_baseline", "fwd_mpix_s",
        "fwd_vs_baseline", "garden_ms_frame", "garden_mpix_s",
        "parity_pass"}


def _small_garden():
    scene, eye, look = bench.bench_scene(1500)
    return scene, eye * 0.8, look


@pytest.mark.parametrize("outcome,want_pass,want_rc", [
    (0, True, 0), (1, False, 1), (None, None, 1)])
def test_line_and_parity_outcome(monkeypatch, capsys, outcome, want_pass,
                                 want_rc):
    """A default run (train, forward, garden, parity) at a tiny size: the
    line has bench.py's keys and the four new ones; parity_pass is the
    check's exit code 0 (None when it cannot run), and a check that did
    not pass makes main return 1 after the line."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        if outcome is None:
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
        return subprocess.CompletedProcess(cmd, outcome, "", "")

    monkeypatch.setattr(bench, "garden_scene", _small_garden)
    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    assert bench.main(TINY) == want_rc
    line = _line(capsys)
    assert set(line) == _jax_bench_keys() | NEW_KEYS
    assert line["parity_pass"] is want_pass
    assert line["value"] > 0 and line["fwd_mpix_s"] > 0
    assert line["garden_mpix_s"] > 0 and line["ms_step"] > 0
    assert line["card"] == "cpu"
    # a CPU run measures no device
    assert line["device_ms_step"] is None and line["busy"] is None
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "gaussiansplattingviewer_tpu_torch.eval."
                       "gradcheck", "--ci", "--bench-scale"]
    paths = kw["env"]["PYTHONPATH"].split(":")
    assert paths == [str(ROOT), "/elsewhere"]


@pytest.mark.parametrize("flag,metric", [
    ("--forward-only", "Mpix/s/chip fwd 1080p"),
    ("--no-fuse", "Mpix/s/chip fwd+bwd 1080p")])
def test_forward_only_and_no_fuse_run(capsys, flag, metric):
    assert bench.main(TINY + [flag, "--no-garden", "--no-parity"]) == 0
    line = _line(capsys)
    assert line["metric"] == metric and line["value"] > 0
    # bench.py re-measures the forward only after the fused training run
    assert "fwd_mpix_s" not in line and "parity_pass" not in line


@pytest.mark.parametrize("main", [bench.main, ply_roundtrip.main,
                                  scaling.main],
                         ids=["bench", "ply_roundtrip", "scaling"])
def test_cuda_without_a_card_exits_nonzero(monkeypatch, tmp_path, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"]
    if main is not bench.main:
        argv += ["--out", str(tmp_path / "out.json")]
    assert main(argv) != 0
    assert not (tmp_path / "out.json").exists()


def test_union_of_kernel_intervals():
    assert bench._union_us([]) == 0
    assert bench._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert bench._union_us([(4, 9), (0, 1), (2, 10)]) == 9


@pytest.mark.parametrize("backend", ["kernel", "tile"])
def test_first_step_matches_jax_value_and_grad(backend):
    """The bench's first training step (its scene, pose and loss) against
    JAX's value_and_grad of sum(img^2) through the ``tile`` backend."""
    cfg = JaxConfig(width=96, height=64, grad_fold_bf16=False)
    j_sc = jax_scene(2000, sh_degree=3, seed=0, extent=4.0,
                     mean_scale=0.015).pad_to_multiple(1024)
    cam = JaxCamera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0, 0, 9.0], np.float32)
    j_view = jnp.asarray(jtf.look_at(eye, np.zeros(3), [0, -1, 0]))
    j_proj = jnp.asarray(cam.get_project_matrix())

    def loss(s):
        img, aux = jax_render_with_aux(s, j_view, j_proj, jnp.asarray(eye),
                                       cfg, backend="tile")
        return jnp.sum(img * img), aux

    (j_loss, aux), j_grads = jax.value_and_grad(loss, has_aux=True)(
        j_sc.to_device())
    assert int(aux["overflow"]) == 0 == int(aux["truncated"])

    scene, p_eye, look = bench.bench_scene(2000)
    scene = scene.pad_to_multiple(1024)
    for f in FIELDS:  # the same parameters, bit for bit
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(j_sc, f)))
    pcfg = port_cfg(cfg)
    view, proj, cam_pos = bench.pose(pcfg, p_eye, look)
    np.testing.assert_array_equal(view, np.asarray(j_view))
    leaves = GaussianData(*(getattr(scene, f).clone().requires_grad_()
                            for f in FIELDS))
    losses = bench.train_steps(leaves, view, proj, cam_pos, pcfg, backend,
                               "cpu", 1)
    j_loss = float(j_loss)
    assert j_loss > 0
    assert abs(float(losses[0]) - j_loss) <= 1e-5 * j_loss
    for f in FIELDS:
        want = np.asarray(getattr(j_grads, f))
        scale = float(np.abs(want).max())
        assert scale > 0, f
        np.testing.assert_allclose(getattr(leaves, f).grad.numpy(), want,
                                   atol=1e-5 * scale, rtol=0, err_msg=f)
