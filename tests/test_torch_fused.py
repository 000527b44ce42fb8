"""PyTorch port: the fused prefix/residual path (ops/fused.py) against the
JAX package's, on the CPU through the plain versions of kernels B1, B2, B4
and B5.

Kernel level, on a JAX bin_splats table (JAX Pallas in interpret mode):
  * B4 (``tile_raster_fwd_seeded``) against ``rasterize_binned_pallas_
    seeded`` from a random t_init: nproc equal; T and the checkpoints the
    port writes within 1e-6 (the Pallas kernel forms T as exp of a sum of
    logs, the port as a sequential product, as for B2 in
    test_torch_blend_bwd.py); rgb within 1e-5 * max(1, |ref|);
  * B5 (``tile_raster_bwd_fused``) with a nonzero suffix seed and
    t_entry != 1, per gradient row on the live columns: within 2e-6 of an
    f64 evaluation of the same math and within 3e-5 (rgb, opacity) or
    1e-4 (centre, conic) of ``blend_bwd_fused``, whose moment
    recombination adds up to 5.7e-5; the id row equal there, every other
    column zero;
  * ``fold_rows_by_id`` and ``bin_splats_presort`` against JAX's.

Render level, test_fused.py's scene (96x64, 2000 splats, SH-1): the
forward against the port's classic render and JAX's fused render, the
gradients of sum(img^2) against ``jax.grad`` of JAX's tile executor
(1e-5 * max|g|, tests/test_grads.py's budget) and of JAX's fused render
(1e-4: it is itself up to 6.2e-5 from the tile executor), and the
diagnostics.  The JAX renders are
computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
from gaussiansplattingviewer_tpu.config import RenderMode as JaxMode
from gaussiansplattingviewer_tpu.models import random_scene
from gaussiansplattingviewer_tpu.ops import binning as jbin
from gaussiansplattingviewer_tpu.ops.fold import fold_rows_by_id as jax_fold
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_bwd import (
    blend_bwd_fused,
)
from gaussiansplattingviewer_tpu.ops.pallas.tile_raster_fwd import (
    rasterize_binned_pallas_seeded,
)
from gaussiansplattingviewer_tpu.ops.render import render as jax_render
from gaussiansplattingviewer_tpu.ops.render import (
    render_with_aux as jax_render_aux,
)
from gaussiansplattingviewer_tpu.utils import transforms as tf
from gaussiansplattingviewer_tpu.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops import fused
from gaussiansplattingviewer_tpu_torch.ops.fold import fold_rows_by_id
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_bwd as kb
from gaussiansplattingviewer_tpu_torch.ops.kernels import tile_raster_fwd as kf
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_with_aux,
)
from torch_port_util import both_splats, port_cfg, port_scene
from torch_port_util import synthetic_splats

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
W, H = 96, 64
PREFIX = dict(fused_grad=True, prefix_rows=256, residual_budget_rows=8192)


# ---------------------------------------------------------------- kernels

def _scene(kind):
    if kind == "early_stop":
        return synthetic_splats(3000, W, H, seed=4, scale=(3.0, 9.0),
                                opacity=(0.9, 1.0))
    if kind == "multi_window":
        crowd = synthetic_splats(1200, W, H, seed=6, centre=(40, 24),
                                 spread=(7, 7), scale=(0.6, 1.5),
                                 opacity=(0.02, 0.05))
        others = synthetic_splats(90, W, H, seed=7, scale=(1.0, 2.0))
        return {f: np.concatenate([others[f], crowd[f]]) for f in crowd}
    return synthetic_splats(700, W, H, seed=3)


def _seeded_both(kind, mode=JaxMode.SH3, train=True):
    """A JAX-binned table (its row 15 a distinct id per column) through
    JAX's seeded forward and the port's B4, from one random t_init."""
    cfg = JaxConfig(width=W, height=H, mode=mode)
    jax_s, _ = both_splats(_scene(kind))
    b = jbin.bin_splats(jax_s, cfg)
    table = np.array(b.table)
    table[15] = np.arange(table.shape[1], dtype=np.float32)
    rng = np.random.default_rng(21)
    t_init = rng.uniform(0.2, 1.0, (cfg.num_tiles, 256)).astype(np.float32)
    if kind == "early_stop":  # some tiles enter already saturated
        t_init[::5] = 5e-5
    j_out = rasterize_binned_pallas_seeded(
        jnp.asarray(table), b.tile_starts, b.tile_counts,
        jnp.asarray(t_init), 0, cfg, train=train)
    pt = (torch.from_numpy(table), torch.from_numpy(np.array(b.tile_starts)),
          torch.from_numpy(np.array(b.tile_counts)))
    p_out = kf.tile_raster_fwd_seeded(*pt, torch.from_numpy(t_init), 0,
                                      port_cfg(cfg), train=train)
    return cfg, (table, b.tile_starts, b.tile_counts), pt, t_init, j_out, \
        p_out


def _read_windows(starts, nproc):
    """(tile, column) of every checkpoint window the backward reads: each
    processed 128-row block with a live row, but the tile's first."""
    s = starts.numpy().astype(np.int64)
    start, end = s[:-1], s[1:]
    base = start // 128 * 128
    nch = np.where(end > start, -(-(end - base) // 256), 0)
    return [(t, base[t] + blk * 128) for t in range(len(start))
            for blk in range(1, 2 * min(int(nproc[t]), int(nch[t])))
            if base[t] + blk * 128 < end[t]]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["plain", "early_stop", "multi_window"])
def test_seeded_forward_matches_pallas(kind, train):
    _, _, (_, starts, _), _, j_out, p_out = _seeded_both(kind, train=train)
    rgb, trans = p_out[0].numpy(), p_out[1].numpy()
    j_rgb, j_t = np.asarray(j_out[0]), np.asarray(j_out[1])
    np.testing.assert_allclose(rgb, j_rgb, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(j_rgb).max()))
    np.testing.assert_allclose(trans, j_t, rtol=0, atol=1e-6)
    if not train:
        return
    ckpt, nproc = p_out[2], p_out[3]
    assert nproc.dtype == torch.int32
    np.testing.assert_array_equal(nproc.numpy(), np.asarray(j_out[3]))
    windows = _read_windows(starts, nproc.numpy())
    assert windows
    j_ck = np.asarray(j_out[2])
    for _, c in windows:
        np.testing.assert_allclose(ckpt[:, c:c + 128].numpy(),
                                   j_ck[:, c:c + 128], atol=1e-6, rtol=0)
    if kind == "early_stop":
        assert (nproc.numpy()[::5] == 0).all()  # entered saturated


def _live_columns(starts, nproc, goff, grad_rows):
    """Compact columns B5 writes: column goff[t] + c - base[t] for every
    live table column c of tile t's processed windows."""
    s = starts.numpy().astype(np.int64)
    live = np.zeros(grad_rows, bool)
    for t in range(len(s) - 1):
        base = s[t] // 128 * 128
        hi = min(s[t + 1], base + 256 * int(nproc[t]))
        live[goff[t] + s[t] - base: goff[t] + hi - base] = True
    return live


@pytest.mark.parametrize("mode,kind", [
    (JaxMode.SH3, "plain"), (JaxMode.SH3, "early_stop"),
    (JaxMode.SH3, "multi_window"), (JaxMode.GAUSSIAN_BALL, "plain"),
])
def test_fused_backward_matches_pallas(mode, kind):
    """Each gradient row on the live columns within 2e-6 * max|row| of the
    same math evaluated in f64 (the plain version on doubles; measured
    9e-7), and within a budget of JAX's Pallas backward: 3e-5 on the rgb
    and opacity rows, 1e-4 on the centre and conic rows, where the Pallas
    kernel's tile-local moment recombination is up to 5.7e-5 of max|row|
    from the f64 value (opaque and crowded scenes, where 1 / (1 - alpha)
    amplifies dL/dalpha)."""
    cfg, (table, j_starts, j_counts), (tb, starts, counts), t_init, j_out, \
        (_, trans, ckpt, nproc) = _seeded_both(kind, mode)
    _, j_t, j_ck, j_np = j_out
    np_eff = np.minimum(nproc.numpy().astype(np.int64),
                        fused._num_chunks(starts, counts).numpy())
    goff = np.concatenate([[0], np.cumsum(np_eff * 256)])[:-1]
    grad_rows = int(np_eff.sum() * 256) + 512
    rng = np.random.default_rng(22)
    g_rgb = rng.normal(size=(cfg.num_tiles, 256, 3)).astype(np.float32)
    g_t = rng.normal(size=(cfg.num_tiles, 256)).astype(np.float32)
    suffix = rng.normal(size=(cfg.num_tiles, 256)).astype(np.float32)
    args = (tb, starts, counts, torch.from_numpy(np_eff.astype(np.int32)),
            torch.from_numpy(goff.astype(np.int32)), ckpt, 0,
            torch.from_numpy(g_rgb), torch.from_numpy(g_t), trans,
            torch.from_numpy(suffix), torch.from_numpy(t_init))
    got = kb.tile_raster_bwd_fused(*args, grad_rows, port_cfg(cfg)).numpy()
    px, py = kf.tile_pixel_grid(port_cfg(cfg), cfg.tiles_y)
    d = [a.double() if a.is_floating_point() else a for a in args
         if isinstance(a, torch.Tensor)]
    f64 = kb.blend_tiles_bwd_plain(
        d[0], starts[:-1], counts, d[3], d[5], px.double(), py.double(),
        d[6], d[7], d[8], port_cfg(cfg), suffix_init=d[9], t_entry=d[10],
        goff=d[4], grad_rows=grad_rows).numpy()
    want = np.asarray(blend_bwd_fused(
        jnp.asarray(table), j_starts, j_counts,
        jnp.asarray(np_eff.astype(np.int32)),
        jnp.asarray(goff.astype(np.int32)), j_ck, 0, jnp.asarray(g_rgb),
        jnp.asarray(g_t), j_t, jnp.asarray(suffix), jnp.asarray(t_init),
        grad_rows, cfg))
    live = _live_columns(starts, np_eff, goff, grad_rows)
    assert live.sum() > 0
    np.testing.assert_array_equal(got[:, ~live], 0.0)
    np.testing.assert_array_equal(got[15, live], want[15, live])
    used = 0
    for c in range(binning.GRAD_WIDTH):
        scale = np.abs(want[c, live]).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got[c], 0.0, err_msg=f"row {c}")
            continue
        used += 1
        np.testing.assert_allclose(got[c, live], f64[c, live], rtol=0,
                                   atol=2e-6 * scale, err_msg=f"row {c}")
        rel = 1e-4 if c <= binning.COL_C else 3e-5
        np.testing.assert_allclose(got[c, live], want[c, live], rtol=0,
                                   atol=rel * scale, err_msg=f"row {c}")
    assert used == (9 if mode == JaxMode.SH3 else 3)


def test_fold_rows_by_id_matches_jax():
    """test_fused.py's fold inputs: heavy rows, an absent id, a
    never-written tail (id 0, zero gradient)."""
    rng = np.random.default_rng(0)
    n, g_rows = 500, 7000
    ids = rng.integers(0, n, size=g_rows)
    ids[ids == 17] = 18
    g = np.zeros((g_rows, binning.TABLE_WIDTH), np.float32)
    g[:, : binning.GRAD_WIDTH] = rng.normal(
        size=(g_rows, binning.GRAD_WIDTH)).astype(np.float32)
    g[: g_rows // 4, : binning.GRAD_WIDTH] *= 1e4
    g[:, binning.COL_COUNT] = ids.astype(np.float32)
    g[-64:, : binning.GRAD_WIDTH] = 0
    g[-64:, binning.COL_COUNT] = 0
    for bf16 in (False, True):
        want = np.asarray(jax_fold(jnp.asarray(g.T), n, bf16))
        got = fold_rows_by_id(torch.from_numpy(g.T.copy()), n, bf16).numpy()
        assert got.shape == (n, binning.TABLE_WIDTH)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert np.abs(got[17]).max() == 0.0
        assert np.abs(got[:, binning.GRAD_WIDTH:]).max() == 0.0


@pytest.mark.parametrize("band", [{}, dict(row_offset=1, local_rows=2,
                                           row_stride=2)])
def test_presort_matches_jax(band):
    """The port's lists of a row set are the whole image's lists of those
    rows, bit for bit: its depth key is sized by the image's tile count
    (JAX sizes a band's by the band's, which can reorder near-equal
    depths), so a band is held to JAX's whole-image presort on its tiles."""
    cfg = JaxConfig(width=W, height=H)
    jax_s, port_s = both_splats(_scene("multi_window"))
    want = jbin.bin_splats_presort(jax_s, cfg, **band)
    got = binning.bin_splats_presort(port_s, port_cfg(cfg), **band)
    full = jbin.bin_splats_presort(jax_s, cfg)
    starts = np.asarray(full.starts_full)
    rows = np.asarray(full.rows_sorted)
    local = band.get("local_rows", cfg.tiles_y)
    tiles = [(band.get("row_offset", 0) + s * band.get("row_stride", 1))
             * cfg.tiles_x + x for s in range(local)
             for x in range(cfg.tiles_x)]
    lists = [rows[starts[t]:starts[t + 1]] for t in tiles]
    np.testing.assert_array_equal(
        got.starts_full.numpy(),
        np.concatenate([[0], np.cumsum([len(r) for r in lists])]))
    live = int(want.num_duplicates)
    assert int(got.num_duplicates) == live == got.rows_sorted.shape[0]
    np.testing.assert_array_equal(got.rows_sorted.numpy(),
                                  np.concatenate(lists))
    assert int(got.overflow) == int(want.overflow)


# ----------------------------------------------------------- the render

def _setup():
    cfg = JaxConfig(width=W, height=H, grad_fold_bf16=False)
    scene = random_scene(2000, sh_degree=1, seed=7, extent=2.0,
                         mean_scale=0.04)
    cam = Camera(h=H, w=W)
    cam.fovy = 1.0
    view = np.asarray(tf.look_at([0, 0, 6.0], [0, 0, 0], [0, -1, 0]),
                      np.float32)
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    return cfg, scene, view, proj, np.array([0, 0, 6.0], np.float32)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _jax_grads(setup, **kw):
    """(grads, aux) of sum(img^2) through JAX's fused render (Pallas)."""
    cfg, scene, view, proj, cam_pos = setup
    c = cfg.with_(**kw)

    def loss(s):
        img, aux = jax_render_aux(s, view, proj, cam_pos, c,
                                  backend="pallas")
        return jnp.sum(img * img), aux

    (_, aux), g = jax.value_and_grad(loss, has_aux=True)(scene.to_device())
    return ({f: np.asarray(getattr(g, f)) for f in FIELDS},
            {k: float(v) for k, v in aux.items() if np.ndim(v) == 0})


def _port_grads(setup, **kw):
    cfg, scene, view, proj, cam_pos = setup
    sc = port_scene(scene)
    for f in FIELDS:
        getattr(sc, f).requires_grad_(True)
    img, aux = render_with_aux(sc, view, proj, cam_pos,
                               port_cfg(cfg.with_(**kw)), device="cpu")
    (img * img).sum().backward()
    return ({f: getattr(sc, f).grad.numpy() for f in FIELDS},
            {k: float(v) for k, v in aux.items() if v.dim() == 0})


@pytest.fixture(scope="module")
def jax_fused(setup):
    """JAX's fused renders, computed once: the prefix forward and the
    gradients with prefix 0 and 256."""
    cfg, scene, view, proj, cam_pos = setup
    img = np.asarray(jax_render(scene.to_device(), view, proj, cam_pos,
                                cfg.with_(**PREFIX), backend="pallas"))
    def tile_loss(s):
        img = jax_render(s, view, proj, cam_pos, cfg, backend="tile")
        return jnp.sum(img * img)

    g = jax.grad(tile_loss)(scene.to_device())
    return {"img": img, 0: _jax_grads(setup, fused_grad=True),
            256: _jax_grads(setup, **PREFIX),
            "tile": {f: np.asarray(getattr(g, f)) for f in FIELDS}}


def _port_render(setup, **kw):
    cfg, scene, view, proj, cam_pos = setup
    return render(port_scene(scene), view, proj, cam_pos,
                  port_cfg(cfg.with_(**kw)), device="cpu").numpy()


def test_fused_forward_matches_classic_and_jax(setup, jax_fused):
    classic = _port_render(setup)
    np.testing.assert_array_equal(_port_render(setup, fused_grad=True),
                                  classic)
    img = _port_render(setup, **PREFIX)
    # only the final rgb1 + rgb2 association differs from the classic path
    np.testing.assert_allclose(img, classic, atol=2e-6, rtol=0)
    np.testing.assert_allclose(img, jax_fused["img"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("prefix", [0, 256])
def test_fused_grads_match_jax(setup, jax_fused, prefix):
    """Per field within 1e-5 * max|g| of jax.grad of JAX's tile executor
    (tests/test_grads.py's budget; measured 1.4e-6) and within 1e-4 of
    jax.grad of JAX's fused render, which is itself up to 6.2e-5 from the
    tile executor on rot and scale (its Pallas log-domain prefix and
    moment recombination); the same gradient-row diagnostics."""
    kw = PREFIX if prefix else dict(fused_grad=True)
    want, want_aux = jax_fused[prefix]
    got, aux = _port_grads(setup, **kw)
    for f in FIELDS:
        for ref, rel in ((jax_fused["tile"], 1e-5), (want, 1e-4)):
            scale = np.abs(ref[f]).max() + 1e-6
            np.testing.assert_allclose(got[f], ref[f], atol=rel * scale,
                                       rtol=0, err_msg=f)
        assert np.abs(got[f]).max() > 0, f
    for k in ("grad_rows_needed", "grad_rows_dropped", "truncated"):
        assert aux[k] == want_aux[k], k
    assert aux["grad_rows_needed"] > 0 and aux["grad_rows_dropped"] == 0


def test_fused_bf16_fold_close(setup):
    g32, _ = _port_grads(setup, **PREFIX)
    g16, _ = _port_grads(setup, grad_fold_bf16=True, **PREFIX)
    differs = False
    for f in FIELDS:
        scale = np.abs(g32[f]).max() + 1e-12
        assert np.abs(g32[f] - g16[f]).max() / scale < 0.03, f
        differs |= bool(np.any(g32[f] != g16[f]))
    assert differs


def test_fused_residual_truncation_matches_jax(setup):
    cfg, scene, view, proj, cam_pos = setup
    c = cfg.with_(fused_grad=True, prefix_rows=128, residual_budget_rows=256)
    _, want = jax_render_aux(scene.to_device(), view, proj, cam_pos, c,
                             backend="pallas")
    _, got = render_with_aux(port_scene(scene), view, proj, cam_pos,
                             port_cfg(c), device="cpu")
    assert int(got["truncated"]) == int(want["truncated"]) > 0


def test_fused_grad_budget_overflow_matches_jax(setup):
    want_g, want = _jax_grads(setup, fused_grad=True, grad_budget_rows=512)
    got_g, got = _port_grads(setup, fused_grad=True, grad_budget_rows=512)
    assert got["grad_rows_needed"] == want["grad_rows_needed"] > 512
    assert got["grad_rows_dropped"] == want["grad_rows_dropped"] > 0
    for f in FIELDS:
        assert np.isfinite(got_g[f]).all(), f


def test_fused_inference_diagnostics(setup):
    """Outside autograd the fused forward keeps no residuals (B1 + B4) and
    reports no gradient rows."""
    cfg, scene, view, proj, cam_pos = setup
    launches = (kf.tile_raster_fwd_seeded.launches,
                kb.tile_raster_bwd_fused.launches)
    _, aux = render_with_aux(port_scene(scene), view, proj, cam_pos,
                             port_cfg(cfg.with_(**PREFIX)), device="cpu")
    assert float(aux["grad_rows_needed"]) == 0.0
    assert float(aux["grad_rows_dropped"]) == 0.0
    assert int(aux["num_duplicates"]) > 0 and int(aux["truncated"]) == 0
    # CPU tensors run the plain versions: no kernel launch counted
    assert (kf.tile_raster_fwd_seeded.launches,
            kb.tile_raster_bwd_fused.launches) == launches


def test_fused_wrappers_check_inputs():
    cfg = port_cfg(JaxConfig(width=32, height=32))
    table = torch.zeros((16, 600))
    starts = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    t_init = torch.ones((cfg.num_tiles, 256))
    with pytest.raises(ValueError, match="t_init"):
        kf.tile_raster_fwd_seeded(table, starts, counts, t_init[:, :8], 0,
                                  cfg)
    rgb, trans, ckpt, nproc = kf.tile_raster_fwd_seeded(
        table, starts, counts, t_init, 0, cfg, train=True)
    assert ckpt.shape == (2, 600) and nproc.shape == (cfg.num_tiles,)
    args = [table, starts, counts, nproc, nproc, ckpt, 0, torch.zeros_like(
        rgb), trans, trans, trans, t_init, 256, cfg]
    g = kb.tile_raster_bwd_fused(*args)
    assert g.shape == (16, 256)
    np.testing.assert_array_equal(g.numpy(), 0.0)
    args[4] = nproc.long()
    with pytest.raises(ValueError, match="expected"):
        kb.tile_raster_bwd_fused(*args)
