"""PyTorch port: 2D Gaussian splatting (surfels, ``scale`` (N, 2)) on the
CPU.  The render against the benchmark's plain reference
(``benchmark/reference/surfel.py``) through the kernels' plain versions
(classic and fused), the tile executor and the oracle at tiles 8, 16 and
32, on random, edge-on and low-pass-dominated surfels; the reference's
fragment weight against a ray-plane intersection worked out in world
space; the scene model and both PLY loaders with two scales; gradients
on the CPU against the reference's and autograd's refusal elsewhere; the spans and counters of a surfel render and the benchmark's
readers of the new metrics.

Imports neither JAX nor tests/conftest.py's fixtures."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, traffic
from benchmark.reference import splat as ref_splat
from benchmark.reference import surfel as ref
from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import (
    GaussianData,
    load_ply,
    random_scene,
    save_ply,
)
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_with_aux,
)
from gaussiansplattingviewer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**33 + 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These scenes are small: one intra-op thread each, which keeps the
    file fast where several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# the CPU paths: (backend, RenderConfig overrides)
PATHS = {
    "kernel-classic": ("kernel", {}),
    "kernel-fused": ("kernel", dict(fused_grad=True, prefix_rows=16,
                                    residual_budget_rows=1 << 16)),
    "tile": ("tile", {}),
}


def _config(**kw):
    c = json.loads((ROOT / "benchmark/configs/garden-2dgs.json").read_text())
    c.update(n_splats=600, pad_to=64, width=96, height=64, extent=1.5,
             mean_scale=0.06, eye=[0.0, 0.0, 4.0])
    c.update(kw)
    return c


def _quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(1)
    w2, x2, y2, z2 = b.unbind(1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=1)


def _scene(kind: str):
    """(config, leaves): ``random`` surfels; ``edge_on``, each disk's
    normal at right angles to the orbit's axis of sight (turned 90 degrees
    about y, then by a random angle about z); ``tiny``, disks far under a
    pixel, whose low-pass wins almost everywhere."""
    c = _config(mean_scale=0.003) if kind == "tiny" else _config()
    leaves = ref.make_scene(c, SEED, "cpu")
    if kind == "edge_on":
        n = leaves["rot"].shape[0]
        gen = torch.Generator().manual_seed(1)
        ang = torch.rand(n, generator=gen) * math.pi
        about_y = torch.tensor([math.cos(math.pi / 4), 0.0,
                                math.sin(math.pi / 4), 0.0]).expand(n, 4)
        about_z = torch.stack([torch.cos(ang / 2), torch.zeros(n),
                               torch.zeros(n), torch.sin(ang / 2)], dim=1)
        leaves["rot"] = _quat_mul(about_z, about_y).contiguous()
    return c, leaves


def _render(c, leaves, pose, ts, path):
    backend, kw = PATHS[path]
    cfg = RenderConfig(width=c["width"], height=c["height"], tile_size=ts,
                       **kw)
    with torch.no_grad():
        return render(GaussianData(**leaves), *pose, cfg, backend=backend,
                      device="cpu")


def _reference(c, leaves, pose, ts, monkeypatch):
    """The reference's image, binned at the tile ``ts`` (its depth keys
    then have the program's width)."""
    monkeypatch.setattr(ref_splat, "TILE", ts)
    monkeypatch.setattr(ref, "TILE", ts)
    image, _, stats = ref.render(leaves, *pose, c["width"], c["height"])
    assert stats["fragments"] > 0
    return image


def _rms(img, want):
    return float((img - want).norm() / want.norm())


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "edge_on", "tiny"])
def test_render_matches_the_reference(kind, ts, path, monkeypatch):
    c, leaves = _scene(kind)
    pose = traffic.orbit(c, 8, "cpu")[1]
    img = _render(c, leaves, pose, ts, path)
    want = _reference(c, leaves, pose, ts, monkeypatch)
    assert float(want.abs().max()) > 0.1
    assert _rms(img, want) < 2e-5


@pytest.mark.parametrize("kind", ["random", "edge_on", "tiny"])
def test_oracle_matches_the_reference(kind, monkeypatch):
    """The oracle orders by the exact depth, the reference by binning's
    depth keys: near-equal depths may swap, hence the wider limit."""
    c, leaves = _scene(kind)
    pose = traffic.orbit(c, 8, "cpu")[2]
    with torch.no_grad():
        img = render(GaussianData(**leaves), *pose,
                     RenderConfig(width=c["width"], height=c["height"]),
                     backend="oracle", device="cpu")
    want = _reference(c, leaves, pose, 16, monkeypatch)
    assert _rms(img, want) < 5e-4


def test_the_tight_cull_changes_nothing():
    """Surfels keep every binned candidate (the tight cull is 3DGS's, the
    blend culls surfel fragments exactly): ``tight_culling`` off renders
    the same bits, on every kind of scene, the edge-on included."""
    for kind in ("random", "edge_on", "tiny"):
        c, leaves = _scene(kind)
        pose = traffic.orbit(c, 8, "cpu")[1]
        cfg = RenderConfig(width=c["width"], height=c["height"])
        scene = GaussianData(**leaves)
        with torch.no_grad(), profiling.collect() as rec:
            img = render(scene, *pose, cfg, device="cpu")
            full = render(scene, *pose, cfg.with_(tight_culling=False),
                          device="cpu")
        assert rec.counts["bin.pairs"] == rec.counts["bin.candidates"] > 0
        assert torch.equal(img, full), kind


def _pixel_ray(view, proj, width, height, x, y):
    """World-space origin and direction of the ray through pixel centre
    (x, y), float64."""
    inv = torch.linalg.inv((proj.double() @ view.double()))
    ndc_x = 2.0 * x / width - 1.0
    ndc_y = 1.0 - 2.0 * y / height
    pts = []
    for z in (-1.0, 1.0):
        p = inv @ torch.tensor([ndc_x, ndc_y, z, 1.0], dtype=torch.float64)
        pts.append(p[:3] / p[3])
    return pts[0], pts[1] - pts[0]


def test_reference_weight_is_the_ray_disk_intersection():
    """One large surfel, white, over black: the reference's pixel is its
    alpha.  Where the ray meets the disk (rho3d <= rho2d), alpha is
    min(0.99, o exp(-rho3d / 2)) with rho3d from the intersection of the
    pixel's ray with the disk's plane, solved in world space."""
    c = _config(width=64, height=48)
    pose = traffic.orbit(c, 8, "cpu")[0]
    view, proj, _ = pose
    q = torch.tensor([[0.9, 0.3, -0.2, 0.25]])
    q = q / q.norm()
    o = 0.8
    leaves = {"xyz": torch.tensor([[0.05, -0.03, 0.1]]), "rot": q,
              "scale": torch.tensor([[0.35, 0.2]]),
              "opacity": torch.tensor([[o]]),
              "sh": torch.cat([torch.full((1, 3), 0.5 / ref_splat.SH_C0),
                               torch.zeros((1, 45))], dim=1)}
    image, _, _ = ref.render(leaves, *pose, c["width"], c["height"])
    rot = ref_splat.rotation(q).double()[0]
    mu = leaves["xyz"].double()[0]
    su, sv = leaves["scale"].double()[0]
    attrs, _, _ = ref.project(leaves, *pose, c["width"], c["height"])
    cx, cy = float(attrs[0, 0]), float(attrs[1, 0])
    checked = 0
    for py in range(1, c["height"], 3):
        for px in range(1, c["width"], 3):
            x, y = px + 0.5, py + 0.5
            origin, d = _pixel_ray(view, proj, c["width"], c["height"], x, y)
            a = torch.stack([su * rot[:, 0], sv * rot[:, 1], -d], dim=1)
            u, v, _ = torch.linalg.solve(a, origin - mu)
            rho3d = float(u * u + v * v)
            rho2d = 2.0 * ((x - cx) ** 2 + (y - cy) ** 2)
            alpha = min(0.99, o * math.exp(-rho3d / 2.0))
            if rho3d > rho2d or alpha < 2.0 / 255.0:
                continue
            assert abs(float(image[py, px, 0]) - alpha) < 1e-4, (px, py)
            checked += 1
    assert checked >= 10


def test_program_weight_is_the_references_on_a_single_surfel():
    """The same surfel through the program (kernel plain versions): the
    pixel is alpha to rounding."""
    c = _config(width=64, height=48)
    pose = traffic.orbit(c, 8, "cpu")[0]
    q = torch.tensor([[0.9, 0.3, -0.2, 0.25]])
    leaves = {"xyz": torch.tensor([[0.05, -0.03, 0.1]]), "rot": q / q.norm(),
              "scale": torch.tensor([[0.35, 0.2]]),
              "opacity": torch.tensor([[0.8]]),
              "sh": torch.cat([torch.full((1, 3), 0.5 / ref_splat.SH_C0),
                               torch.zeros((1, 45))], dim=1)}
    image, _, _ = ref.render(leaves, *pose, c["width"], c["height"])
    for ts in (8, 16, 32):
        # the one surfel spans 16 tiles of 8 px, more rows than the
        # default budget's 8 per splat
        cfg = RenderConfig(width=c["width"], height=c["height"],
                           tile_size=ts, table_budget_rows=64)
        with torch.no_grad():
            got, aux = render_with_aux(GaussianData(**leaves), *pose, cfg,
                                       device="cpu")
        assert int(aux["truncated"]) == 0
        assert float((got - image).abs().max()) < 1e-6


@pytest.mark.parametrize("kind", ["random", "edge_on", "tiny"])
def test_reference_counts_the_fragments_in_each_rect(kind, monkeypatch):
    """The fragments ``render`` counts for the bound lie in the rows'
    rects, which hold every fragment that reaches alpha_min (rounding
    aside) and fewer pixels than the rows' whole tiles."""
    c, leaves = _scene(kind)
    pose = traffic.orbit(c, 8, "cpu")[1]
    seen = {"kept": 0, "outside": 0, "live": 0}
    blend = ref._blend

    def recorded(rows, live, px, py):
        out = blend(rows, live, px, py)
        keep, in_rect = out[3], out[2]
        seen["kept"] += int(keep.sum())
        seen["outside"] += int((keep & ~in_rect).sum())
        seen["live"] += int(live.sum()) * px.shape[1]
        return out

    monkeypatch.setattr(ref, "_blend", recorded)
    _, _, stats = ref.render(leaves, *pose, c["width"], c["height"])
    assert seen["kept"] > 0
    assert seen["outside"] <= 1e-4 * seen["kept"]
    assert 0 < stats["fragments"] < seen["live"]


# ---- the scene model and PLY


def _surfel_data(n=50, seed=3):
    leaves = ref.make_scene(_config(n_splats=n, pad_to=1), seed, "cpu")
    return GaussianData(**leaves)


def test_scene_model_takes_two_scales():
    s = _surfel_data()
    assert s.surfel and not random_scene(10).surfel
    padded = s.pad_to(64)
    assert padded.scale.shape == (64, 2) and padded.surfel
    assert torch.all(padded.opacity[50:] == 0)
    assert torch.equal(padded.select(torch.arange(50)).scale, s.scale)
    flat = s.flat()
    assert flat.shape == (50, 10 + s.sh_dim)
    back = GaussianData.from_flat(flat, s.sh_dim)
    for f in ("xyz", "rot", "scale", "opacity", "sh"):
        assert torch.equal(getattr(back, f), getattr(s, f)), f
    three = random_scene(7, sh_degree=3)
    assert GaussianData.from_flat(three.flat(), 48).scale.shape == (7, 3)
    assert s.concat(s).scale.shape == (100, 2)


def test_concat_refuses_mixed_primitives():
    with pytest.raises(ValueError, match="one primitive"):
        _surfel_data().concat(random_scene(50, sh_degree=3))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_two_scale_ply_round_trips(tmp_path, use_native):
    """A surfel scene saves as a 2DGS PLY (scale_0, scale_1) and loads
    back as one through either loader, the two loaders bit-equal."""
    from gaussiansplattingviewer_tpu_torch import native

    if use_native and native.get_lib() is None:
        pytest.skip("the native library is not available")
    s = _surfel_data()
    path = tmp_path / "surfels.ply"
    save_ply(s, path)
    header = path.read_bytes().split(b"end_header")[0].decode()
    assert "scale_1" in header and "scale_2" not in header
    got, _, _ = load_ply(path, use_native=use_native)
    other, _, _ = load_ply(path, use_native=not use_native)
    assert got.scale.shape == (50, 2)
    for f in ("xyz", "rot", "scale", "opacity", "sh"):
        assert torch.equal(getattr(got, f), getattr(other, f)), f
        assert torch.allclose(getattr(got, f), getattr(s, f), rtol=1e-5,
                              atol=1e-6), f


# ---- what a surfel scene refuses


def test_autograd_through_a_surfel_scene_raises():
    """Off the CPU (the card; here the meta device, which computes
    nothing) autograd through a surfel scene raises before any work: the
    card has no 2DGS backward kernels.  The blend entry points refuse such
    a table too."""
    from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
    from gaussiansplattingviewer_tpu_torch.ops.fused import blend_fused

    c, leaves = _scene("random")
    pose = traffic.orbit(c, 8, "cpu")[1]
    cfg = RenderConfig(width=c["width"], height=c["height"])
    params = {k: a.to("meta").requires_grad_(True)
              for k, a in leaves.items()}
    for backend in ("kernel", "tile", "oracle"):
        with pytest.raises(NotImplementedError, match="2DGS training"):
            render(GaussianData(**params), *pose, cfg, backend=backend,
                   device="meta")
    table = torch.zeros((16, 512), device="meta", requires_grad=True)
    starts = torch.zeros((cfg.num_tiles + 1,), dtype=torch.int32,
                         device="meta")
    with pytest.raises(NotImplementedError, match="backward kernel"):
        blend_tiles(cfg, cfg.tiles_y, 1, table, starts, starts[1:], 0,
                    surfel=True)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        blend_fused(cfg, cfg.tiles_y, 1, table.T, starts, starts, 0,
                    surfel=True)
    # grad mode on with leaves that need none renders, as under no_grad
    img = render(GaussianData(**leaves), *pose, cfg, device="cpu")
    assert not img.requires_grad
    params = {k: a.clone().requires_grad_(True) for k, a in leaves.items()}
    with torch.no_grad():
        assert torch.equal(img, render(GaussianData(**params), *pose, cfg,
                                       device="cpu"))


@pytest.mark.parametrize("path", sorted(PATHS) + ["oracle"])
def test_cpu_gradients_match_the_reference(path):
    """On the CPU autograd differentiates the plain versions: the image,
    the loss sum(img^2) and every leaf's gradient match the reference's
    autograd (the program stops a tile at T < 1e-4, the reference blends
    every row; the oracle orders by exact depth)."""
    backend, kw = PATHS.get(path, ("oracle", {}))
    c, leaves = _scene("random")
    pose = traffic.orbit(c, 8, "cpu")[3]
    cfg = RenderConfig(width=c["width"], height=c["height"], **kw)
    params = {k: a.clone().requires_grad_(True) for k, a in leaves.items()}
    img = render(GaussianData(**params), *pose, cfg, backend=backend,
                 device="cpu")
    (img * img).sum().backward()
    ref_leaves = {k: a.clone().requires_grad_(True)
                  for k, a in leaves.items()}
    want, loss, _ = ref.render(ref_leaves, *pose, c["width"], c["height"],
                               grad=True)
    tol = 5e-4 if backend == "oracle" else 2e-5
    img = img.detach()
    assert _rms(img, want) < tol
    assert abs(float((img * img).sum()) - float(loss)) < tol * float(loss)
    for k in ref.LEAVES:
        g, r = params[k].grad, ref_leaves[k].grad
        assert float(r.norm()) > 0, k
        assert float((g - r).norm() / r.norm()) < 1e-3, k


@pytest.mark.parametrize("mode", [RenderMode.BILLBOARD, RenderMode.FLAT_BALL,
                                  RenderMode.GAUSSIAN_BALL])
def test_billboard_and_ball_modes_refuse_surfels(mode):
    c, leaves = _scene("random")
    pose = traffic.orbit(c, 8, "cpu")[1]
    cfg = RenderConfig(width=c["width"], height=c["height"], mode=mode)
    with pytest.raises(ValueError, match=mode.name):
        with torch.no_grad():
            render(GaussianData(**leaves), *pose, cfg, device="cpu")


@pytest.mark.parametrize("mode", [RenderMode.SH0, RenderMode.SH2,
                                  RenderMode.DEPTH])
def test_sh_and_depth_modes_agree_across_paths(mode):
    """Other SH degrees and DEPTH render alike on every CPU path (the
    plain kernels classic and fused, the tile executor)."""
    c, leaves = _scene("random")
    pose = traffic.orbit(c, 8, "cpu")[4]
    imgs = {}
    for path, (backend, kw) in PATHS.items():
        cfg = RenderConfig(width=c["width"], height=c["height"], mode=mode,
                           **kw)
        with torch.no_grad():
            imgs[path] = render(GaussianData(**leaves), *pose, cfg,
                                backend=backend, device="cpu")
    base = imgs.pop("kernel-classic")
    assert float(base.abs().max()) > 0.01
    for path, img in imgs.items():
        assert float((img - base).abs().max()) < 1e-5, path


def test_autotune_takes_a_surfel_scene():
    """The autotuner probes through the surfel path and takes the fused
    path, whose render matches the reference."""
    c = _config(n_splats=3000, width=96, height=64, mean_scale=0.2)
    leaves = ref.make_scene(c, SEED, "cpu")
    poses = traffic.orbit(c, 8, "cpu")
    cfg = autotune(GaussianData(**leaves), *zip(*poses[:4]),
                   RenderConfig(width=c["width"], height=c["height"]),
                   probe=True, fused=None)
    assert cfg.fused_grad
    with torch.no_grad():
        img, aux = render_with_aux(GaussianData(**leaves), *poses[6], cfg,
                                   device="cpu")
    want, _, _ = ref.render(leaves, *poses[6], c["width"], c["height"])
    assert int(aux["truncated"]) == 0
    assert _rms(img, want) < 2e-5


# ---- spans, counters and the benchmark's readers


def test_surfel_render_records_its_stages_and_counters():
    c, leaves = _scene("random")
    pose = traffic.orbit(c, 8, "cpu")[1]
    cfg = RenderConfig(width=c["width"], height=c["height"])
    with torch.no_grad(), profiling.collect() as rec:
        render(GaussianData(**leaves), *pose, cfg, device="cpu")
    recs = rec.resolve()
    names = {r.name for r in recs}
    assert {"render", "project", "bin", "blend"} <= names
    assert len({r.request for r in recs}) == 1
    n = leaves["xyz"].shape[0]
    assert rec.counts["project.surfel_splats"] == n
    assert "project.kernel_splats" not in rec.counts  # no kernel on the CPU
    assert 0 < rec.counts["bin.pairs"] <= rec.counts["bin.candidates"]


def test_3dgs_binning_counts_its_candidates():
    scene = random_scene(400, sh_degree=1, seed=5, extent=1.2,
                         mean_scale=0.12)
    c = _config()
    pose = traffic.orbit(c, 8, "cpu")[1]
    cfg = RenderConfig(width=c["width"], height=c["height"])
    with torch.no_grad(), profiling.collect() as rec:
        render(scene, *pose, cfg, device="cpu")
    assert "project.surfel_splats" not in rec.counts
    assert 0 < rec.counts["bin.pairs"] <= rec.counts["bin.candidates"]


class _Run:
    """What the readers see of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _reader(name):
    return cells.Spec(ROOT).reader(name)


def test_new_readers_are_none_off_the_card():
    spec = cells.Spec(ROOT)
    off = _Run(events=None, steps=10, work=ref.WORK, n_splats=100,
               window_s=1.0)
    for name in ("project_roofline.view", "cull_kept.view"):
        assert spec.reader(name)(off) is None, name


def test_new_readers_divide_by_the_windows_frames():
    events = [("void project_surfel_fwd_kernel<3, false>", 0.0, 2e-3),
              ("tile_raster_fwd_kernel<16, 4, false, false>", 2e-3, 5e-3),
              ("void project_surfel_fwd_kernel<3, false>", 1.0, 1.002)]
    n = 5_800_960
    run = _Run(events=events, steps=2, work=ref.WORK, n_splats=n,
               window_s=2.0)
    bound = n * ref.WORK["splat_bytes"] / 3.35e12
    got = _reader("project_roofline.view")(run)
    assert got == pytest.approx(100.0 * bound / 2e-3)
    assert 0 < got < 100
    # no P1s in the trace (the parent's program, a 3DGS scene): nothing
    run3 = _Run(events=events[1:2], steps=2, work=ref.WORK, n_splats=n,
                window_s=2.0)
    assert _reader("project_roofline.view")(run3) is None
    run3.work = ref_splat.WORK
    assert _reader("project_roofline.view")(run3) is None

    rec = profiling.Recorder()
    rec.records.append(object())
    rec.counts["bin.pairs"] += 300
    rec.counts["bin.candidates"] += 1200
    run4 = _Run(events=events, steps=3, program_spans=rec)
    assert _reader("cull_kept.view")(run4) == pytest.approx(25.0)
    del rec.counts["bin.candidates"]
    run5 = _Run(events=events, steps=3, program_spans=rec)
    assert _reader("cull_kept.view")(run5) is None


def test_the_cell_is_configured():
    spec = cells.Spec(ROOT)
    cell = spec.cell("garden-2dgs-view")
    config = spec.config(cell["config"])
    assert config["reference"] == "surfel" and config["render"] == {}
    assert -(-config["n_splats"] // config["pad_to"]) * config["pad_to"] \
        == 5_800_960
    assert (config["width"], config["height"], config["sh_degree"]) == (
        1920, 1080, 3)
    assert spec.reference(config).WORK == ref.WORK
    names = {m["name"] for m in spec.per_layer("garden-2dgs-view")}
    assert {"project_roofline.view", "cull_kept.view", "blend_roofline.view",
            "bin_pairs.view", "device_ms.view"} <= names
    assert np.isclose(spec.limits("garden-2dgs-view")["img_rms"], 1e-3)


def _toy_cell_config():
    spec = cells.Spec(ROOT)
    config = spec.config("garden-2dgs")
    config.update(n_splats=1500, width=64, height=48, extent=1.5,
                  mean_scale=0.04, eye=[0.0, 0.0, 4.0])
    return spec, config


def test_the_cell_runs_and_judges_at_a_toy_size():
    """garden-2dgs-view's harness path at a toy size on the CPU: the
    program's frames pass the cell's limit, the TF32 control does not."""
    import time

    from benchmark import cell

    spec, config = _toy_cell_config()
    ref_mod = spec.reference(config)
    mix, limits = spec.traffic("view"), spec.limits("garden-2dgs-view")
    out = cell.run(config, ref_mod, mix, limits, 2**31 + 29, 0.1, False,
                   "cpu", time.perf_counter())
    assert out.correct and out.gaps and out.failed == 0
    assert out.checks["img_rms"]["value"] < 1e-4
    assert out.work["splat_bytes"] == 301
    control = cell.control(config, ref_mod, mix, limits, 2**31 + 29, "cpu")
    assert not control.correct
