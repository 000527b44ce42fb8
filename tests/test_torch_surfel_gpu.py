"""PyTorch port on the card: the 2D Gaussian splatting (surfel) kernels
against their plain PyTorch versions on the same card tensors: P1s
(``csrc/projection_surfel.cu``) against ``_project_surfel``, B1s, B2s and
B4s (``csrc/tile_raster_fwd_surfel.cu``) against the plain blend at tiles
8, 16 and 32; the surfel render on the card against the CPU's and the
benchmark's plain reference (``benchmark/reference/surfel.py``), classic
and fused, and through the autotuner; the kernels' resources as built.

Imports neither JAX nor tests/conftest.py's fixtures:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_surfel_gpu.py

Without a card every test here skips."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import traffic
from benchmark.reference import splat as ref_splat
from benchmark.reference import surfel as ref
from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops import binning, projection
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.kernels import projection as kp
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as b1
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_with_aux,
)
from gaussiansplattingviewer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = ("mean2d", "depth", "transform", "radius", "valid")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _config(n=4000, width=256, height=160, mean_scale=0.04):
    c = json.loads((ROOT / "benchmark/configs/garden-2dgs.json").read_text())
    c.update(n_splats=n, pad_to=128, width=width, height=height,
             extent=1.5, mean_scale=mean_scale, eye=[0.0, 0.0, 4.0])
    return c


def _case(dev, seed=2**33 + 5, **kw):
    c = _config(**kw)
    leaves = ref.make_scene(c, seed, dev)
    poses = traffic.orbit(c, 8, dev)
    return c, leaves, poses


def _close(got, want, rel=1e-5):
    tol = rel * max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [RenderMode.SH3, RenderMode.SH1,
                                  RenderMode.DEPTH])
def test_project_surfel_kernel_matches_plain(mode):
    """P1s against ``_project_surfel`` on the card: the geometry bit for
    bit, colour within rounding; one launch, counted, and the counters."""
    dev = _card()
    c, leaves, poses = _case(dev)
    cfg = RenderConfig(width=c["width"], height=c["height"], mode=mode)
    scene = GaussianData(**leaves)
    launches = kp.project_surfel_fwd.launches
    with profiling.collect() as rec, torch.no_grad():
        got = projection.project(scene, *poses[1], cfg)
    assert kp.project_surfel_fwd.launches == launches + 1
    assert rec.counts["project.surfel_splats"] == len(scene)
    assert rec.counts["project.kernel_splats"] == len(scene)
    want = projection._project_surfel(scene, *poses[1], cfg)
    assert got.conic is None and got.surfel
    assert int(want.valid.sum()) > 1000
    for f in GEOMETRY:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert _close(got.color, want.color)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_surfel_blend_kernels_match_plain(ts):
    """B1s, B2s and B4s against the plain blend on the same card table:
    transmittance, checkpoints and windows bit for bit, rgb within
    summation order."""
    dev = _card()
    c, leaves, poses = _case(dev)
    cfg = RenderConfig(width=c["width"], height=c["height"], tile_size=ts)
    with torch.no_grad():
        splats = projection.project(GaussianData(**leaves), *poses[2], cfg)
        bins = binning.bin_splats(splats, cfg)
    assert bins.surfel and int(bins.num_duplicates) > 1000
    args = (bins.table, bins.tile_starts, bins.tile_counts, 0, cfg)
    rgb, trans = b1.tile_raster_fwd(*args, surfel=True)
    prgb, ptrans = b1.tile_raster_fwd_plain(*args, surfel=True)
    assert torch.equal(trans, ptrans) and _close(rgb, prgb)
    assert float(trans.min()) < 0.5  # the surfels cover the frame
    out = b1.tile_raster_fwd_train(*args, surfel=True)
    want = b1.tile_raster_fwd_train_plain(*args, surfel=True)
    assert _close(out[0], want[0])
    for a, b in zip(out[1:], want[1:]):
        assert torch.equal(a, b)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    t_init = torch.rand(trans.shape, generator=gen, device=dev)
    seeded = b1.tile_raster_fwd_seeded(
        bins.table, bins.tile_starts, bins.tile_counts, t_init, 0, cfg,
        surfel=True)
    pseeded = b1.tile_raster_fwd_seeded_plain(
        bins.table, bins.tile_starts, bins.tile_counts, t_init, 0, cfg,
        surfel=True)
    assert torch.equal(seeded[1], pseeded[1])
    assert _close(seeded[0], pseeded[0])


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["classic", "fused"])
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_surfel_render_on_card_matches_cpu_and_reference(ts, fused,
                                                         monkeypatch):
    """The surfel render on the card (P1s, B1s / B1s + B4s) against the
    CPU's plain versions and the plain reference, binned at the same
    tile; with a table that holds every binned pair (at 8 px they
    outgrow the default budget's 8 rows per surfel)."""
    dev = _card()
    c, leaves, poses = _case(dev)
    w, h = c["width"], c["height"]
    cfg = RenderConfig(width=w, height=h, tile_size=ts,
                       table_budget_rows=1 << 18)
    if fused:
        cfg = cfg.with_(fused_grad=True, prefix_rows=64,
                        residual_budget_rows=1 << 18)
    monkeypatch.setattr(ref_splat, "TILE", ts)
    monkeypatch.setattr(ref, "TILE", ts)
    with torch.no_grad():
        img, aux = render_with_aux(GaussianData(**leaves), *poses[3], cfg,
                                   device=dev)
        cpu = render(GaussianData(**leaves).to("cpu"),
                     *(p.cpu() for p in poses[3]), cfg, device="cpu")
        expected, _, _ = ref.render(leaves, *poses[3], w, h)
    assert int(aux["truncated"]) == 0
    assert float((img.cpu() - cpu).norm() / cpu.norm()) < 1e-5
    assert float((img - expected).norm() / expected.norm()) < 2e-5


@pytest.mark.gpu
def test_surfel_autotune_on_card():
    """The autotuner probes a surfel scene through the surfel kernels
    (B2s) and the tuned render matches the reference."""
    dev = _card()
    c, leaves, poses = _case(dev, n=20000, mean_scale=0.08)
    w, h = c["width"], c["height"]
    cfg = autotune(GaussianData(**leaves), *zip(*poses[:4]),
                   RenderConfig(width=w, height=h), probe=True, fused=None)
    with torch.no_grad():
        img = render(GaussianData(**leaves), *poses[5], cfg, device=dev)
        expected, _, _ = ref.render(leaves, *poses[5], w, h)
    assert float((img - expected).norm() / expected.norm()) < 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("train,seeded", [(False, False), (True, False),
                                          (False, True)])
def test_surfel_blend_kernel_resources(ts, train, seeded):
    """B1s, B2s and B4s build and report their resources (printed: the
    registers, spills, shared memory and CTAs per SM as built)."""
    _card()
    occ = b1.kernel_occupancy(RenderMode.SH3, train=train, seeded=seeded,
                              tile_size=ts, surfel=True)
    print(f"surfel tile {ts} train {train} seeded {seeded}: {occ}")
    assert occ["registers"] > 0 and occ["ctas_per_sm"] >= 1
