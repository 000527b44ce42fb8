"""PyTorch port: every eval function against the JAX package's copy on
seeded numpy inputs, bit for bit where both run the same numpy code (or to
1e-6), LPIPS on a random local state dict, and compare_backends rendering
through the port."""

import os
import zipfile

import numpy as np
import pytest

import gaussiansplattingviewer_tpu.eval as jax_eval
import gaussiansplattingviewer_tpu_torch.eval as port_eval
from gaussiansplattingviewer_tpu.eval import blur as jblur
from gaussiansplattingviewer_tpu.eval import disp_scale as jds
from gaussiansplattingviewer_tpu.eval import metrics as jmetrics
from gaussiansplattingviewer_tpu.eval import outliers as joutliers
from gaussiansplattingviewer_tpu.eval import packaging as jpack
from gaussiansplattingviewer_tpu.eval import plots as jplots
from gaussiansplattingviewer_tpu.eval import reproject as jrep
from gaussiansplattingviewer_tpu.eval import sharpen as jsharp
from gaussiansplattingviewer_tpu.eval import viz as jviz
from gaussiansplattingviewer_tpu_torch.eval import blur, disp_scale, metrics
from gaussiansplattingviewer_tpu_torch.eval import outliers, packaging, plots
from gaussiansplattingviewer_tpu_torch.eval import reproject, sharpen, viz
from gaussiansplattingviewer_tpu_torch.utils.image_io import write_rgb8


def _same(got, want):
    """Equal, recursively, floats to 1e-6 (NaN to NaN)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float", "gray"])
@pytest.mark.parametrize("fn", ["mse", "psnr", "ssim"])
def test_metrics(fn, kind):
    a, b = _images(0)
    if kind == "uint16":
        a, b = a[..., 0].astype(np.uint16) * 257, b[..., 0].astype(
            np.uint16) * 257
    elif kind == "float":
        a, b = a / 255.0, b / 255.0
    elif kind == "gray":
        a, b = a[..., 1], b[..., 1]
    _same(getattr(metrics, fn)(a, b), getattr(jmetrics, fn)(a, b))
    assert metrics.psnr(a, a) == float("inf")


def test_compare_image_dirs(tmp_path):
    for d in ("x", "y"):
        (tmp_path / d).mkdir()
    for i in range(3):
        a, b = _images(i)
        write_rgb8(tmp_path / "x" / f"{i}.png", a)
        write_rgb8(tmp_path / "y" / f"{i}.png", b if i else a)
    for m in ("psnr", "ssim", "mse"):
        _same(metrics.compare_image_dirs(str(tmp_path / "x"),
                                         str(tmp_path / "y"), m),
              jmetrics.compare_image_dirs(str(tmp_path / "x"),
                                          str(tmp_path / "y"), m))


@pytest.mark.parametrize("h_size", [11, 23])
def test_blur(h_size, tmp_path):
    a, _ = _images(1)
    for img in (a, a[..., 0], a / 255.0):
        _same(blur.blur_effect(img, h_size), jblur.blur_effect(img, h_size))
    write_rgb8(tmp_path / "a.png", a)
    write_rgb8(tmp_path / "black.png", np.zeros_like(a))
    _same(blur.blur_scores_for_dir(str(tmp_path), h_size),
          jblur.blur_scores_for_dir(str(tmp_path), h_size))


def _disparity(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    d = np.full((h, w), 8.0) + rng.normal(0, 0.05, (h, w))
    d[:, w // 2:] = 16.0
    d[rng.random((h, w)) < 0.02] = 0.0
    return d


def test_reproject():
    d = _disparity(2)
    rgb = np.random.default_rng(3).integers(0, 256, (*d.shape, 3),
                                            dtype=np.uint8)
    d16 = (np.clip(d / 64.0, 0, 1) * 65535).astype(np.uint16)
    _same(reproject.disparity16_to_pixels(d16, 64),
          jrep.disparity16_to_pixels(d16, 64))
    _same(reproject.disparity_to_depth(d, 500.0, -0.5),
          jrep.disparity_to_depth(d, 500.0, -0.5))
    for kw in ({}, dict(rgb=rgb, stride=2), dict(rgb=rgb / 255.0,
                                                 max_depth=40.0, cx=30.0)):
        _same(reproject.disparity_to_pointcloud(d, 500.0, 0.5, **kw),
              jrep.disparity_to_pointcloud(d, 500.0, 0.5, **kw))


def test_save_pointcloud_ply(tmp_path):
    pts, cols = reproject.disparity_to_pointcloud(
        _disparity(4), 500.0, 0.5, rgb=np.full((48, 64, 3), 0.5), stride=3)
    for c in (None, cols):
        reproject.save_pointcloud_ply(tmp_path / "p.ply", pts, c)
        jrep.save_pointcloud_ply(tmp_path / "j.ply", pts, c)
        assert (tmp_path / "p.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()


def test_outliers():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.normal(0, 0.1, (300, 3)),
                          rng.uniform(-3, 3, (15, 3))])
    _same(outliers.remove_statistical_outliers(pts),
          joutliers.remove_statistical_outliers(pts))
    _same(outliers.remove_statistical_outliers(pts[:10]),
          joutliers.remove_statistical_outliers(pts[:10]))
    _same(outliers.outlier_score(pts, 10, 1.5),
          joutliers.outlier_score(pts, 10, 1.5))
    d = _disparity(6)
    rgb = np.random.default_rng(7).random((*d.shape, 3))
    for kw in ({}, dict(rgb=rgb, ao_threshold=0.5)):
        _same(outliers.disparity_outlier_metric(d, 500.0, 0.5, **kw),
              joutliers.disparity_outlier_metric(d, 500.0, 0.5, **kw))


@pytest.mark.parametrize("threshold", [1.0, 5.0, 1e9])
def test_sharpen(threshold):
    d = _disparity(8)
    _same(sharpen.flying_pixel_mask(d, threshold),
          jsharp.flying_pixel_mask(d, threshold))
    _same(sharpen.sharpen_disparity(d, threshold),
          jsharp.sharpen_disparity(d, threshold))


def test_disp_scale():
    d = _disparity(9)
    rng = np.random.default_rng(10)
    for x, y in rng.uniform(-2, 70, (20, 2)):
        _same(disp_scale.bilinear_sample(d, x, y),
              jds.bilinear_sample(d, x, y))
    pl = rng.uniform(0, 63, (30, 2))
    pr = pl - np.stack([rng.uniform(5, 20, 30), np.zeros(30)], 1)
    _same(disp_scale.disparity_scale_from_matches(pl, pr, d),
          jds.disparity_scale_from_matches(pl, pr, d))
    _same(disp_scale.disparity_scale_from_matches(pl[:0], pr[:0], d),
          jds.disparity_scale_from_matches(pl[:0], pr[:0], d))


def test_disp_scale_calibration():
    """The full SIFT pipeline where OpenCV is installed (else both raise)."""
    rng = np.random.default_rng(11)
    left = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
    right = np.roll(left, -6, axis=1)
    d = np.full((96, 128), 6.0)
    if disp_scale._cv2() is None:
        with pytest.raises(RuntimeError):
            disp_scale.calibrate_disparity_scale(left, right, d)
        return
    _same(disp_scale.calibrate_disparity_scale(left, right, d),
          jds.calibrate_disparity_scale(left, right, d))


def test_packaging(tmp_path):
    root = tmp_path / "root"
    for scene, n in (("s1", 2), ("s2", 3)):
        for sub in ("left", "right", "depth"):
            (root / scene / sub).mkdir(parents=True)
            for i in range(n):
                (root / scene / sub / f"{i}.png").write_bytes(b"x")
    (root / "loose.txt").write_text("-")
    _same(packaging.check_scene_files(str(root), expected=2),
          jpack.check_scene_files(str(root), expected=2))
    out = packaging.zip_scene(str(root / "s1"), str(tmp_path / "p.zip"))
    jpack.zip_scene(str(root / "s1"), str(tmp_path / "j.zip"))
    names = [sorted(zipfile.ZipFile(z).namelist()) for z in (out, tmp_path
                                                             / "j.zip")]
    assert names[0] == names[1] and len(names[0]) == 6
    zips = packaging.zip_all_scenes(str(root))
    assert [os.path.basename(z) for z in zips] == ["s1.zip", "s2.zip"]
    got = packaging.unzip_all(str(root), str(tmp_path / "u"))
    assert got == jpack.unzip_all(str(root), str(tmp_path / "v")) \
        == ["s1.zip", "s2.zip"]
    assert sorted(os.listdir(tmp_path / "u")) == ["s1", "s2"]


def test_plots(tmp_path):
    rng = np.random.default_rng(12)
    series = {"a": rng.random(40).tolist(), "b": rng.random(5).tolist()}
    _same(plots.moving_average(series["a"], 9),
          jplots.moving_average(series["a"], 9))
    _same(plots.moving_average(series["b"], 9),
          jplots.moving_average(series["b"], 9))
    _same(plots.plot_blur_scores(series, str(tmp_path / "p.png")),
          jplots.plot_blur_scores(series, str(tmp_path / "j.png")))
    _same(plots.plot_chunked_median(series, str(tmp_path / "pc.png"), 4),
          jplots.plot_chunked_median(series, str(tmp_path / "jc.png"), 4))
    plots.plot_outlier_scores({"0.5": [0.1, 0.2]}, str(tmp_path / "o.png"))
    for f in ("p.png", "pc.png", "o.png"):
        assert (tmp_path / f).stat().st_size > 0


def test_viz(tmp_path):
    rng = np.random.default_rng(13)
    d16 = rng.integers(0, 65535, (30, 40)).astype(np.uint16)
    _same(viz.normalize_depth_for_display(d16),
          jviz.normalize_depth_for_display(d16))
    _same(viz.normalize_depth_for_display(np.zeros((3, 3))),
          jviz.normalize_depth_for_display(np.zeros((3, 3))))
    _same(viz.colormap_disparity(d16, 0.7), jviz.colormap_disparity(d16, 0.7))
    left = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    disp = np.full((30, 40), 3.0)
    _same(viz.stereo_shift_check(left, left[:, ::-1], disp),
          jviz.stereo_shift_check(left, left[:, ::-1], disp))
    for img in (left, left[..., 0].astype(np.float32)):
        _same(viz.radial_undistort(img, 0.2, 0.05),
              jviz.radial_undistort(img, 0.2, 0.05))
    (tmp_path / "b.csv").write_text("name,score\na,0.5\nb,2.0\nc,1.0\n")
    viz.normalize_blur_csv(str(tmp_path / "b.csv"), str(tmp_path / "p.csv"))
    jviz.normalize_blur_csv(str(tmp_path / "b.csv"), str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_plot_camera_path(tmp_path):
    from gaussiansplattingviewer_tpu_torch.utils.colmap import ColmapPose

    poses = [ColmapPose(i, np.array([1.0, 0.0, 0.1 * i, 0.0]),
                        np.array([0.0, 0.0, -3.0 + i]), 1, f"{i}.png")
             for i in range(4)]
    viz.plot_camera_path(poses, str(tmp_path / "path.png"))
    assert (tmp_path / "path.png").stat().st_size > 0


@pytest.fixture(scope="module")
def random_weights(tmp_path_factory):
    """tests/test_lpips.py's random AlexNet-LPIPS state dict."""
    import torch

    g = torch.Generator().manual_seed(0)
    sd = {}
    for idx, (co, ci, k) in {0: (64, 3, 11), 3: (192, 64, 5),
                             6: (384, 192, 3), 8: (256, 384, 3),
                             10: (256, 256, 3)}.items():
        sd[f"features.{idx}.weight"] = torch.randn(co, ci, k, k,
                                                   generator=g) * 0.05
        sd[f"features.{idx}.bias"] = torch.zeros(co)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=g)
    path = tmp_path_factory.mktemp("lpips") / "alex_rand.pth"
    torch.save(sd, str(path))
    return str(path)


def test_lpips_random_weights(random_weights):
    rng = np.random.default_rng(14)
    a = rng.random((64, 64, 3)).astype(np.float32)
    b = rng.random((64, 64, 3)).astype(np.float32)
    g = (rng.random((64, 64)) * 255).astype(np.uint8)
    for x, y in ((a, b), (b, a), (a, a), (g, g)):
        got = port_eval.lpips_distance(x, y, weights_path=random_weights)
        assert got == jax_eval.lpips_distance(x, y,
                                              weights_path=random_weights)
    assert port_eval.lpips_distance(a, a, weights_path=random_weights) == 0.0
    assert port_eval.lpips_available() is False
    with pytest.raises(ImportError):
        port_eval.lpips_distance(a, a)
    with pytest.raises(ValueError):
        port_eval.lpips_distance(a, a, net="vgg", weights_path=random_weights)


def test_compare_backends_through_the_port():
    """kernel against oracle on the CPU (the plain versions), and each
    image against the JAX backends' on the same scene."""
    from gaussiansplattingviewer_tpu.config import RenderConfig as JaxConfig
    from gaussiansplattingviewer_tpu.eval.compare import (
        compare_backends as jax_compare,
    )
    from gaussiansplattingviewer_tpu.models import random_scene
    from gaussiansplattingviewer_tpu.utils import transforms as tf
    from gaussiansplattingviewer_tpu.utils.camera import Camera
    from gaussiansplattingviewer_tpu_torch.eval.compare import (
        compare_backends,
    )
    from torch_port_util import port_cfg, port_scene

    cfg = JaxConfig(width=64, height=48)
    scene = random_scene(300, sh_degree=2, seed=15, extent=1.5,
                         mean_scale=0.05)
    eye = np.array([0.2, 0.1, 3.0], np.float32)
    view = tf.look_at(eye, [0, 0, 0], [0, -1, 0])
    proj = Camera(h=48, w=64).get_project_matrix()
    got = compare_backends(port_scene(scene), view, proj, eye, port_cfg(cfg),
                           ("kernel", "oracle"), device="cpu")
    want = jax_compare(scene.to_device(), view, proj, eye, cfg,
                       backends=("tile", "oracle"))
    assert got.keys() == {"images", "kernel_vs_oracle"}
    assert got["kernel_vs_oracle"]["max_abs"] <= 1e-4
    assert got["kernel_vs_oracle"]["psnr"] > 60
    for ours, theirs in (("kernel", "tile"), ("oracle", "oracle")):
        np.testing.assert_allclose(got["images"][ours],
                                   want["images"][theirs], atol=1e-5)
