"""PyTorch port: the tile-row-sharded render and train step
(gaussiansplattingviewer_tpu_torch.parallel) in real process groups: 2 and
4 gloo processes on the CPU, each rank one shard.

One spawn per world size runs every mode (module fixture ``runs``): the
replicated contiguous, interleaved and pre-culled bands, ``shard_splats``
with and without ``gather_budget_factor``, and ``exchange`` (contiguous
and interleaved); each returns its image and the gradient of sum(img * w),
summed over the ranks (replicated) or gathered from the shards.  Both are
held to the port's single-process render at 1e-5 (relative to max|g| for
gradients); the modes with ``use_kernel=False`` blend on the tile executor
and are held to ``render(backend="tile")``.  The spawn also runs 3 sharded
train steps (replicated and exchange) and, with 2 ranks, the trainer CLI
with ``--n-devices 2``, with the kernel and the tile backend.

The processes meet through a ``file://`` rendezvous under the test's
temporary directory, never a fixed port.  This module imports no JAX: the
spawned workers import it."""

import dataclasses
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import random_scene
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops.render import render
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
CFG = RenderConfig(width=96, height=80, grad_fold_bf16=False)
N_SPLATS = 602  # not a multiple of 4: shard_scene_splats pads
MODES = {
    "contiguous": {},
    "interleaved": dict(interleaved=True),
    "precull": dict(precull_budget_factor=2.5),
    "shard": dict(shard_splats=True),
    "shard_gather_budget": dict(shard_splats=True, gather_budget_factor=0.25),
    "exchange": dict(shard_splats=True, exchange=True),
    "exchange_interleaved": dict(shard_splats=True, exchange=True,
                                 interleaved=True),
    "tile": dict(use_kernel=False),
    "exchange_tile": dict(shard_splats=True, exchange=True,
                          use_kernel=False),
}
TRAIN_MODES = {"replicated": {}, "exchange": dict(shard_splats=True,
                                                  exchange=True)}
WORLD_SIZES = (2, 4)


def _inputs():
    scene = random_scene(N_SPLATS, sh_degree=1, seed=12, extent=2.0,
                         mean_scale=0.06)
    cam = Camera(h=CFG.height, w=CFG.width)
    view = tf.look_at([0, 0, 3], [0, 0, 0], [0, -1, 0])
    eye = np.array([0, 0, 3.0], np.float32)
    weights = torch.from_numpy(np.random.default_rng(3).normal(
        size=(CFG.height, CFG.width, 3)).astype(np.float32))
    return scene, view, cam.get_project_matrix(), eye, weights


def _leaves(scene):
    return GaussianData(*(getattr(scene, f).detach().clone()
                          .requires_grad_(True) for f in FIELDS))


def _gather_shards(t, n_total):
    """Each rank's shard rows -> the whole (n_total, ...) tensor."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return torch.cat(out)[:n_total]


def _modes(mesh, scene, view, proj, eye, weights):
    from gaussiansplattingviewer_tpu_torch import parallel

    out = {}
    for name, kw in MODES.items():
        fn = parallel.make_sharded_render_fn(mesh, CFG, **kw)
        if kw.get("shard_splats"):
            sc = _leaves(parallel.shard_scene_splats(scene, mesh))
        else:
            sc = _leaves(parallel.replicate_scene(scene, mesh))
        img = fn(sc, view, proj, eye)
        (img * weights).sum().backward()
        params = [getattr(sc, f) for f in FIELDS]
        if kw.get("shard_splats"):
            grads = [_gather_shards(p.grad, N_SPLATS) for p in params]
        else:
            parallel.all_reduce_grads(params, mesh)
            grads = [p.grad for p in params]
        out[name] = {"img": img.detach(),
                     **{f: g.detach() for f, g in zip(FIELDS, grads)}}
    return out


def _train(mesh, scene, view, proj, eye):
    from gaussiansplattingviewer_tpu_torch import parallel

    # a darkened target keeps the loss and its gradients nonzero
    with torch.no_grad():
        target = 0.7 * render(scene, view, proj, eye, CFG, device="cpu")
    out = {}
    for name, kw in TRAIN_MODES.items():
        step = parallel.make_sharded_train_step(
            mesh, CFG, optimizer=lambda p: torch.optim.Adam(p, lr=5e-3),
            **kw)
        if kw.get("shard_splats"):
            sc = _leaves(parallel.shard_scene_splats(scene, mesh))
        else:
            sc = _leaves(parallel.replicate_scene(scene, mesh))
        opt, losses = None, []
        for _ in range(3):
            sc, opt, loss = step(sc, opt, view, proj, eye, target)
            losses.append(float(loss))
        out[name] = {"losses": losses,
                     "params": [getattr(sc, f).detach() for f in FIELDS]}
    return out


def _cli(tmp, backend="kernel"):
    from gaussiansplattingviewer_tpu_torch.apps import train

    return train.main(["--n-devices", str(dist.get_world_size()),
                       "--device", "cpu", "--self-distill", "--steps", "2",
                       "--width", "64", "--height", "48", "--log-every", "1",
                       "--backend", backend,
                       "--out", os.path.join(tmp, f"trained_{backend}.npz")])


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    res = {}
    try:
        from gaussiansplattingviewer_tpu_torch import parallel

        assert parallel.initialize_distributed(
            f"file://{os.path.join(tmp, 'rendezvous')}", world, rank,
            device="cpu") == (rank, world)
        assert dist.get_backend() == "gloo"
        mesh = parallel.make_mesh(world)
        scene, view, proj, eye, weights = _inputs()
        res["modes"] = _modes(mesh, scene, view, proj, eye, weights)
        res["train"] = _train(mesh, scene, view, proj, eye)
        if world == 2:
            res["cli_rc"] = _cli(tmp)
            res["cli_tile_rc"] = _cli(tmp, "tile")
        dist.destroy_process_group()
    except Exception:  # the parent reports it: a worker must not go down
        res["error"] = traceback.format_exc()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: [each rank's results]} from one spawn per size."""
    ctx = mp.get_context("spawn")
    out = {}
    for world in WORLD_SIZES:
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        procs = [ctx.Process(target=_worker, args=(r, world, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, f"{world} ranks: a worker hung"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode
                                                     for p in procs]
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(world)]
        for r in res:
            assert "error" not in r, r["error"]
        out[world] = res
    return out


@pytest.fixture(scope="module")
def reference():
    """The port's single-process image and gradients of sum(img * w), for
    the kernel and the tile backend."""
    scene, view, proj, eye, weights = _inputs()
    out = {}
    for backend in ("kernel", "tile"):
        sc = _leaves(scene)
        img = render(sc, view, proj, eye, CFG, backend=backend,
                     device="cpu")
        (img * weights).sum().backward()
        out[backend] = {"img": img.detach(),
                        **{f: getattr(sc, f).grad for f in FIELDS}}
    return out


@pytest.mark.parametrize("world", WORLD_SIZES)
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_render_matches_single_process(runs, reference, world,
                                               mode):
    reference = reference[
        "kernel" if MODES[mode].get("use_kernel", True) else "tile"]
    for rank, res in enumerate(runs[world]):
        got = res["modes"][mode]
        np.testing.assert_allclose(got["img"].numpy(),
                                   reference["img"].numpy(), atol=1e-5,
                                   err_msg=f"rank {rank}")
        for f in FIELDS:
            want = reference[f].numpy()
            scale = float(np.abs(want).max())
            assert scale > 0, f
            np.testing.assert_allclose(got[f].numpy(), want,
                                       atol=1e-5 * scale,
                                       err_msg=f"{f} rank {rank}")


@pytest.mark.parametrize("world", WORLD_SIZES)
@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_sharded_train_step(runs, world, mode):
    """The loss falls over 3 steps and is the same on every rank; with a
    replicated scene every rank ends with the same parameters, bit for
    bit."""
    results = [res["train"][mode] for res in runs[world]]
    losses = results[0]["losses"]
    assert losses[-1] < losses[0], losses
    for r in results[1:]:
        assert r["losses"] == losses
        if mode == "replicated":
            for a, b in zip(r["params"], results[0]["params"]):
                assert torch.equal(a, b)


def test_trainer_cli_two_ranks(runs):
    assert [res["cli_rc"] for res in runs[2]] == [0, 0]


def test_trainer_cli_two_ranks_tile_backend(runs):
    """``--n-devices`` takes the tile backend (as the JAX app does): the
    bands blend on the tile executor."""
    assert [res["cli_tile_rc"] for res in runs[2]] == [0, 0]


def test_trainer_refuses_wrong_world_size(monkeypatch):
    from gaussiansplattingviewer_tpu_torch.apps import train

    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="needs 2 processes"):
        train.main(["--n-devices", "2", "--device", "cpu", "--steps", "1"])


def test_make_mesh_needs_a_group():
    from gaussiansplattingviewer_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(2)


def test_exchange_needs_shard_splats():
    from gaussiansplattingviewer_tpu_torch.parallel import (
        make_sharded_render_fn,
    )
    from gaussiansplattingviewer_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(group=None, rank=0, world_size=2,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="shard_splats"):
        make_sharded_render_fn(mesh, CFG, exchange=True)
    assert dataclasses.is_dataclass(mesh)
