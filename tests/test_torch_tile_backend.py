"""PyTorch port: the ``tile`` backend, the tile executor of ops/blend.py
(``use_kernel=False``), held to the JAX package's XLA executor (JAX's
``tile`` backend, ``use_pallas=False``) on the CPU.

  * render(backend="tile") against JAX's: the forward of 7 modes at tile
    16 and of SH3 at 8 and 32 within 1e-5 (test_golden.py's budget),
    the binning diagnostics equal; the gradient of sum(img * w) per field
    within 1e-5 * max|g| with grad_fold_bf16 off (test_grads.py's);
  * the saturating tile-8 scene of test_torch_tile_train.py, the early
    stop on: the tile executor's forward and table cotangent against
    JAX's within 1e-5 (per row 1e-5 * max|g[row]|), while the kernel
    route (one stop test per 256-row window, JAX's Pallas semantics) is
    more than 1e-5 off JAX's tile executor, so the scene separates them;
  * blend_tiles(use_kernel=False) on an interleaved band (row_offset 1,
    row_stride 2) against jax.vjp of JAX blend_tiles(use_pallas=False);
  * the band program (_render_band) on the tile executor against
    render(backend="tile")'s rows; rasterize_tiles with fused_grad and
    use_kernel=False takes the classic path, as JAX's does;
  * the renderer and the apps with --backend tile (the renderer's frame
    within 1e-5 of JAX's, the viewer's PNG within 1 LSB of the JAX
    viewer's), an unknown backend exits 2; compare_backends' default of
    all three backends; the parity check (eval.gradcheck) at a tiny size,
    and its --ci without a card exits non-zero.
"""

import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.apps import viewer as jax_viewer
from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.eval.compare import (
    compare_backends as jax_compare,
)
from gaussiansplattingviewer_tpu.models import naive_gaussian, random_scene
from gaussiansplattingviewer_tpu.ops.binning import bin_splats as jax_bin
from gaussiansplattingviewer_tpu.ops.blend import blend_tiles as jax_blend
from gaussiansplattingviewer_tpu.ops.render import render as jax_render
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_with_aux,
)
from gaussiansplattingviewer_tpu.renderer import TPURenderer
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.apps import (
    dataset_gen,
    serve,
    train,
    viewer,
)
from gaussiansplattingviewer_tpu_torch.eval import gradcheck
from gaussiansplattingviewer_tpu_torch.eval.compare import compare_backends
from gaussiansplattingviewer_tpu_torch.models import (
    naive_gaussian as port_naive,
)
from gaussiansplattingviewer_tpu_torch.models import (
    random_scene as port_random_scene,
)
from gaussiansplattingviewer_tpu_torch.models import save_ply
from gaussiansplattingviewer_tpu_torch.ops import blend, raster_tiles
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_with_aux,
)
from gaussiansplattingviewer_tpu_torch.parallel.sharded_render import (
    _render_band,
    band_pixel_rows,
)
from gaussiansplattingviewer_tpu_torch.renderer import TorchRenderer
from gaussiansplattingviewer_tpu_torch.utils.camera import (
    Camera as PortCamera,
)
from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image
from torch_port_util import both_splats, port_cfg, port_scene, \
    synthetic_splats

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
W, H = 96, 64
# (tile size, mode, whether the gradients are compared too)
RENDER_CASES = [
    *((16, m, m in (JaxMode.SH3, JaxMode.GAUSSIAN_BALL))
      for m in (JaxMode.SH1, JaxMode.SH2, JaxMode.SH3, JaxMode.DEPTH,
                JaxMode.BILLBOARD, JaxMode.FLAT_BALL, JaxMode.GAUSSIAN_BALL)),
    (8, JaxMode.SH3, True), (32, JaxMode.SH3, True)]
AUX_KEYS = ("num_duplicates", "overflow", "truncated")


@pytest.fixture(scope="module")
def scene():
    sc = random_scene(1500, sh_degree=3, seed=21, extent=2.0,
                      mean_scale=0.05)
    eye = np.array([0.2, -0.1, 5.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    cam = Camera(h=H, w=W)
    cam.fovy = 1.0
    return sc, view, cam.get_project_matrix(), eye


def _cfg(ts, mode):
    return JaxConfig(width=W, height=H, tile_size=ts, mode=mode,
                     grad_fold_bf16=False, table_budget_rows=1 << 16)


@pytest.mark.parametrize("ts,mode,grads", RENDER_CASES)
def test_tile_render_matches_jax_tile(scene, ts, mode, grads):
    """The image and transmittance within 1e-5, the diagnostics equal and,
    for ``grads``, the gradient of sum(img * w) per field within
    1e-5 * max|g| (fields JAX leaves at zero exactly zero)."""
    sc, view, proj, eye = scene
    cfg = _cfg(ts, mode)
    w = np.random.default_rng(ts).normal(size=(H, W, 3)).astype(np.float32)

    def loss(s):
        img, aux = jax_render_with_aux(s, view, proj, eye, cfg,
                                       backend="tile")
        return jnp.sum(img * jnp.asarray(w)), (img, aux)

    if grads:
        (_, (want, want_aux)), g = jax.value_and_grad(loss, has_aux=True)(
            sc.to_device())
    else:
        _, (want, want_aux) = loss(sc.to_device())
    assert int(want_aux["overflow"]) == 0 == int(want_aux["truncated"])
    leaves = port_scene(sc)
    for f in FIELDS:
        getattr(leaves, f).requires_grad_(grads)
    img, aux = render_with_aux(leaves, view, proj, eye, port_cfg(cfg),
                               backend="tile", device="cpu")
    want = np.asarray(want)
    assert float(want.max()) > 0.05
    np.testing.assert_allclose(img.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux["transmittance"].detach().numpy(),
                               np.asarray(want_aux["transmittance"]),
                               atol=1e-5, rtol=0)
    for k in AUX_KEYS:
        assert int(aux[k]) == int(want_aux[k]), k
    if not grads:
        return
    (img * torch.from_numpy(w)).sum().backward()
    nonzero = 0
    for f in FIELDS:
        want = np.asarray(getattr(g, f))
        got = getattr(leaves, f).grad.numpy()
        scale = float(np.abs(want).max())
        if scale == 0.0:
            np.testing.assert_array_equal(got, 0.0, err_msg=f)
            continue
        nonzero += 1
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0,
                                   err_msg=f)
    # every field in the smooth modes; SH alone in the ball modes, whose
    # alpha is piecewise constant
    assert nonzero == (1 if mode == JaxMode.GAUSSIAN_BALL else 5)


def _rows_close(got, want):
    used = 0
    for c in range(16):
        scale = np.abs(want[c]).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got[c], 0.0, err_msg=f"row {c}")
            continue
        used += 1
        np.testing.assert_allclose(got[c], want[c], atol=1e-5 * scale,
                                   rtol=0, err_msg=f"row {c}")
    return used


def _port_blend(cfg, local_rows, stride, binned, row_offset, g_rgb, g_t,
                use_kernel):
    table = torch.from_numpy(np.array(binned.table)).requires_grad_(True)
    starts = torch.from_numpy(np.array(binned.tile_starts))
    counts = torch.from_numpy(np.array(binned.tile_counts))
    pc = port_cfg(cfg)
    rgb, trans = blend.blend_tiles(pc, local_rows, stride, table, starts,
                                   counts, row_offset, use_kernel=use_kernel)
    g, = torch.autograd.grad((rgb, trans), table, (torch.from_numpy(g_rgb),
                                                   torch.from_numpy(g_t)))
    return rgb.detach().numpy(), trans.detach().numpy(), g.numpy()


def _jax_blend_vjp(cfg, local_rows, stride, binned, row_offset, g_rgb, g_t):
    (rgb, trans), vjp = jax.vjp(
        lambda tb: jax_blend(cfg, False, local_rows, stride, tb,
                             binned.tile_starts, binned.tile_counts,
                             jnp.int32(row_offset)), binned.table)
    (g,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_t)))
    return np.asarray(rgb), np.asarray(trans), np.asarray(g)


def test_saturating_tile_8_separates_the_executors():
    """The early stop on, 3,000 opaque splats at tile 8: JAX's XLA executor
    stops tiles every 16 rows, the kernels every 256.  The tile executor
    follows the first within 1e-5 (forward and table cotangent), the kernel
    route misses it by more than 1e-5."""
    width, height, ts = 96, 64, 8
    splats = synthetic_splats(3000, width, height, seed=33,
                              scale=(2.0, 6.0), opacity=(0.95, 0.99))
    jax_s, _ = both_splats(splats)
    cfg = JaxConfig(width=width, height=height, tile_size=ts,
                    grad_fold_bf16=False, table_budget_rows=1 << 16)
    binned = jax_bin(jax_s, cfg)
    assert int(binned.truncated) == 0 and int(binned.overflow) == 0
    rng = np.random.default_rng(35)
    g_rgb = rng.normal(size=(cfg.num_tiles, ts * ts, 3)).astype(np.float32)
    g_t = rng.normal(size=(cfg.num_tiles, ts * ts)).astype(np.float32)
    w_rgb, w_t, want = _jax_blend_vjp(cfg, cfg.tiles_y, 1, binned, 0, g_rgb,
                                      g_t)
    # tiles stop before their lists end
    assert float(w_t.max(axis=1).min()) <= cfg.early_stop_transmittance
    rgb, trans, got = _port_blend(cfg, cfg.tiles_y, 1, binned, 0, g_rgb,
                                  g_t, use_kernel=False)
    np.testing.assert_allclose(rgb, w_rgb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(trans, w_t, atol=1e-5, rtol=0)
    assert _rows_close(got, want) == 9

    k_rgb, _, _ = _port_blend(cfg, cfg.tiles_y, 1, binned, 0, g_rgb, g_t,
                              use_kernel=True)
    assert float(np.abs(k_rgb - w_rgb).max()) > 1e-5


def test_band_blend_vjp_matches_jax_xla():
    width, height, ts = 160, 96, 16
    cfg = JaxConfig(width=width, height=height, tile_size=ts,
                    grad_fold_bf16=False, table_budget_rows=1 << 16)
    jax_s, _ = both_splats(synthetic_splats(900, width, height, seed=41))
    local_rows = cfg.tiles_y // 2
    binned = jax_bin(jax_s, cfg, row_offset=1, local_rows=local_rows,
                     row_stride=2)
    assert int(binned.truncated) == 0 and int(binned.overflow) == 0
    n = local_rows * cfg.tiles_x
    rng = np.random.default_rng(42)
    g_rgb = rng.normal(size=(n, ts * ts, 3)).astype(np.float32)
    g_t = rng.normal(size=(n, ts * ts)).astype(np.float32)
    w_rgb, w_t, want = _jax_blend_vjp(cfg, local_rows, 2, binned, 1, g_rgb,
                                      g_t)
    rgb, trans, got = _port_blend(cfg, local_rows, 2, binned, 1, g_rgb, g_t,
                                  use_kernel=False)
    assert float(w_rgb.max()) > 0.1
    np.testing.assert_allclose(rgb, w_rgb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(trans, w_t, atol=1e-5, rtol=0)
    assert _rows_close(got, want) == 9


@pytest.mark.parametrize("interleaved", [False, True])
def test_band_program_on_the_tile_executor(scene, interleaved):
    sc, view, proj, eye = scene
    cfg = port_cfg(_cfg(16, JaxMode.SH3))
    psc = port_scene(sc)
    n = 2
    with torch.no_grad():
        full = render(psc, view, proj, eye, cfg, backend="tile",
                      device="cpu")
        for idx in range(n):
            rows = -(-cfg.tiles_y // n)
            band = _render_band(psc, view, proj, eye, cfg, rows,
                                row_stride=n if interleaved else 1, idx=idx,
                                n_shards=n, use_kernel=False)
            y = band_pixel_rows(cfg, n, idx, interleaved)
            live = y < cfg.height
            np.testing.assert_allclose(band[live, : cfg.width].numpy(),
                                       full[y[live]].numpy(), atol=1e-5,
                                       rtol=0)


def test_fused_config_on_the_tile_executor_is_classic(scene, monkeypatch):
    sc, view, proj, eye = scene
    cfg = port_cfg(_cfg(16, JaxMode.SH3))
    fused = cfg.with_(fused_grad=True, prefix_rows=32,
                      residual_budget_rows=1 << 16)

    def refuse(*a, **k):
        raise AssertionError("the tile executor took the fused path")

    monkeypatch.setattr(raster_tiles, "blend_fused", refuse)
    splats = project(port_scene(sc), view, proj, eye, cfg)
    img, aux = raster_tiles.rasterize_tiles(splats, fused, return_aux=True,
                                            use_kernel=False)
    want, want_aux = raster_tiles.rasterize_tiles(splats, cfg,
                                                  return_aux=True,
                                                  use_kernel=False)
    assert torch.equal(img, want)
    assert aux.keys() == want_aux.keys()
    assert "grad_rows_needed" not in aux


@pytest.mark.parametrize("app", [viewer, dataset_gen, serve, train],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_apps_take_the_tile_backend(app, capsys):
    # dataset_gen's required arguments
    need = ["--gs-model", "s", "--colmap-poses", "p"] \
        if app is dataset_gen else []
    assert app.build_parser().parse_args(
        need + ["--backend", "tile"]).backend == "tile"
    with pytest.raises(SystemExit) as exc:
        app.build_parser().parse_args(need + ["--backend", "pallas"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_viewer_and_dataset_gen_with_tile_backend(tmp_path):
    argv = ["--width", "64", "--height", "48", "--eye", "0", "0", "3",
            "--target", "0", "0", "0", "--backend", "tile"]
    assert jax_viewer.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert viewer.main(argv + ["--device", "cpu",
                               "--out", str(tmp_path / "port")]) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        a = read_image(tmp_path / "port" / name).astype(np.int64)
        b = read_image(tmp_path / "jax" / name).astype(np.int64)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= 1

    ply = tmp_path / "scene.ply"
    save_ply(port_random_scene(300, sh_degree=1, seed=4, extent=1.5,
                               mean_scale=0.05), ply)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    (sparse / "images.txt").write_text(
        "# images.txt\n1 1 0 0 0 0 0 -3 1 im0.png\n0 0 1\n")
    (sparse / "cameras.txt").write_text("1 PINHOLE 64 48 100 100 32 24\n")
    assert dataset_gen.main(["--gs-model", str(ply),
                             "--colmap-poses", str(sparse), "--width", "64",
                             "--height", "48", "--backend", "tile",
                             "--device", "cpu",
                             "--out", str(tmp_path / "data")]) == 0
    assert len(list((tmp_path / "data").rglob("*.png"))) == 3


def test_serve_and_train_with_tile_backend(tmp_path, monkeypatch, capsys):
    args = serve.build_parser().parse_args(
        ["--random-scene", "300", "--width", "96", "--height", "64",
         "--device", "cpu", "--backend", "tile"])
    state = serve.build_state(args)
    asked = []

    def spy(*a, backend="kernel", **kw):
        asked.append(backend)
        return render(*a, backend=backend, **kw)

    monkeypatch.setattr(serve, "render", spy)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/render?yaw=0.3&pitch=0.2",
                timeout=60) as r:
            status, png = r.status, r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    assert asked == ["tile"]

    out = tmp_path / "trained.npz"
    rc = train.main(["--self-distill", "--steps", "2", "--width", "48",
                     "--height", "32", "--log-every", "1", "--backend",
                     "tile", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.exists()
    assert "backend=tile" in capsys.readouterr().err


def test_renderer_draws_through_the_tile_backend():
    """TorchRenderer(backend="tile") against JAX's TPURenderer(backend=
    "tile") on the 4-splat scene, within 1e-5."""
    imgs = []
    for r, scene, cam in (
            (TPURenderer(96, 64, backend="tile"), naive_gaussian()[0],
             Camera(h=64, w=96)),
            (TorchRenderer(96, 64, backend="tile", device="cpu"),
             port_naive()[0], PortCamera(h=64, w=96))):
        cam.camera_position = np.array([0.2, 0.1, 3.0], np.float32)
        r.update_gaussian_data(scene)
        r.update_camera_pose(cam)
        r.update_camera_intrin(cam)
        imgs.append(np.asarray(r.draw()))
    assert imgs[0].max() > 0.1
    np.testing.assert_allclose(imgs[1], imgs[0], atol=1e-5, rtol=0)


def test_compare_backends_default_compares_all_three():
    cfg = JaxConfig(width=64, height=48)
    sc = random_scene(300, sh_degree=2, seed=15, extent=1.5,
                      mean_scale=0.05)
    eye = np.array([0.2, 0.1, 3.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = Camera(h=48, w=64).get_project_matrix()
    got = compare_backends(port_scene(sc), view, proj, eye, port_cfg(cfg),
                           device="cpu")
    want = jax_compare(sc.to_device(), view, proj, eye, cfg,
                       backends=("tile",))
    assert got.keys() == {"images", "oracle_vs_tile", "oracle_vs_kernel",
                          "tile_vs_kernel"}
    np.testing.assert_allclose(got["images"]["tile"], want["images"]["tile"],
                               atol=1e-5, rtol=0)
    assert got["tile_vs_kernel"]["max_abs"] <= 1e-5
    assert got["oracle_vs_tile"]["max_abs"] <= 1e-4


def test_gradcheck_on_the_cpu():
    """The parity check's method at a tiny size: classic and fused (the
    kernel route's plain versions against the tile executor)."""
    small = dict(gradcheck.TOY, n_splats=1500, width=96, height=64)
    for extra in (None, dict(fused_grad=True, prefix_rows=32,
                             residual_budget_rows=1 << 16)):
        res = gradcheck.run_case(**small, cfg_extra=extra, device="cpu")
        assert res["pass"], res
        assert res["config"]["fused_grad"] == (extra is not None)
        assert set(res["fields"]) == set(gradcheck.REPORT_FIELDS)
        assert min(f["grad_scale"] for f in res["fields"].values()) > 1e-6


def test_gradcheck_ci_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "parity.json"
    assert gradcheck.main(["--ci", "--out", str(out)]) != 0
    assert not out.exists()
