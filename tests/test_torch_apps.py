"""PyTorch port: the apps against the JAX package's on the same scene and
flags, on the CPU.

  * viewer: a single frame of a scene dir, an orbit with --save-poses, a
    --poses-csv replay and a DEPTH frame: every PNG within 1 LSB of the
    JAX viewer's (--backend tile), the pose CSVs equal;
  * dataset_gen: the triplets within 1 LSB, the resume (a second run
    renders nothing) and the manifest;
  * render_all: the report, a failing scene recorded and exit code 1;
  * serve and the trainer with --gs-model on a scene dir.
"""

import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from gaussiansplattingviewer_tpu.apps import dataset_gen as jax_dataset_gen
from gaussiansplattingviewer_tpu.apps import render_all as jax_render_all
from gaussiansplattingviewer_tpu.apps import viewer as jax_viewer
from gaussiansplattingviewer_tpu.models import random_scene, save_ply
from gaussiansplattingviewer_tpu_torch.apps import (
    dataset_gen,
    render_all,
    serve,
    train,
    viewer,
)
from gaussiansplattingviewer_tpu_torch.utils.image_io import read_image

PORT = ["--device", "cpu"]
JAX = ["--backend", "tile"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two scene dirs in the reference's layout (point_cloud/
    iteration_30000/point_cloud.ply and a COLMAP sparse/0 with 3 poses),
    as tests/test_apps.py's fixture, and a third without a PLY."""
    root = tmp_path_factory.mktemp("scenes")
    for name, seed in (("0001", 3), ("0002", 4)):
        scene_dir = root / name
        ply_dir = scene_dir / "point_cloud" / "iteration_30000"
        ply_dir.mkdir(parents=True)
        save_ply(random_scene(500, sh_degree=1, seed=seed, extent=1.5,
                              mean_scale=0.05), ply_dir / "point_cloud.ply")
        sparse = scene_dir / "sparse" / "0"
        sparse.mkdir(parents=True)
        lines = ["# images.txt"]
        for i in range(3):
            q = np.array([0.02 * i, 0.01 * i, 1.0, 0.0])
            q /= np.linalg.norm(q)
            t = [0.1 * i, 0.05 * i, -3.0]
            lines.append(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} "
                         f"{t[2]} 1 im{i}.png")
            lines.append("0 0 1")
        (sparse / "images.txt").write_text("\n".join(lines) + "\n")
        (sparse / "cameras.txt").write_text(
            "1 PINHOLE 1160 522 3443.9 3443.9 580 261\n")
    (root / "0003" / "sparse" / "0").mkdir(parents=True)
    return root


def _same_png(a, b):
    """Within 1 LSB per pixel, same shape and dtype."""
    x, y = read_image(a), read_image(b)
    assert x.shape == y.shape and x.dtype == y.dtype, (a, x.shape, y.shape)
    diff = np.abs(x.astype(np.int64) - y.astype(np.int64))
    assert int(diff.max()) <= 1, (a, int(diff.max()))
    return x


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    return [_same_png(a / n, b / n) for n in names]


def _both_viewers(tmp_path, argv):
    for pkg, extra in (("jax", JAX), ("port", PORT)):
        argv_pkg = [a.replace("{pkg}", pkg) for a in argv]
        mod = jax_viewer if pkg == "jax" else viewer
        assert mod.main(argv_pkg + ["--out", str(tmp_path / pkg)]
                        + extra) == 0
    return _same_dirs(tmp_path / "jax", tmp_path / "port")


def test_viewer_single_frame(tmp_path, scenes):
    imgs = _both_viewers(tmp_path, ["--gs-model", str(scenes / "0001"),
                                    "--width", "128", "--height", "96"])
    assert imgs[0].shape == (96, 128, 3) and imgs[0].std() > 1


def test_viewer_orbit_and_poses(tmp_path):
    imgs = _both_viewers(tmp_path, [
        "--width", "64", "--height", "48", "--orbit", "4",
        "--eye", "0", "0", "3", "--target", "0", "0", "0",
        "--save-poses", str(tmp_path / "{pkg}.csv")])
    assert len(imgs) == 4
    rows = (tmp_path / "port.csv").read_text()
    assert rows == (tmp_path / "jax.csv").read_text()
    assert len(rows.strip().split("\n")) == 4


def test_viewer_poses_csv_replay(tmp_path):
    csv_path = tmp_path / "camera_data.csv"
    csv_path.write_text("0,0,-1,0,-1,0,0,0,3\n0,0,-1,0,-1,0,0.2,0,3\n")
    imgs = _both_viewers(tmp_path, ["--width", "64", "--height", "48",
                                    "--poses-csv", str(csv_path)])
    assert len(imgs) == 2


def test_viewer_depth_mode(tmp_path, scenes):
    imgs = _both_viewers(tmp_path, [
        "--gs-model", str(scenes / "0001"), "--width", "64", "--height", "48",
        "--mode", "depth", "--debug"])
    assert imgs[0].dtype == np.uint16 and imgs[0].ndim == 2
    assert int(imgs[0].max()) > 0


def test_dataset_gen_and_resume(tmp_path, scenes):
    argv = ["--gs-model", str(scenes / "0001"),
            "--colmap-poses", str(scenes / "0001" / "sparse" / "0"),
            "--width", "128", "--height", "64"]
    manifests = {}
    for name, mod, extra in (("jax", jax_dataset_gen, JAX),
                             ("port", dataset_gen, PORT)):
        out = tmp_path / name
        assert mod.main(argv + ["--out", str(out)] + extra) == 0
        manifests[name] = json.loads(
            (out / "0001" / "manifest.json").read_text())
    for sub in ("left", "right", "depth"):
        imgs = _same_dirs(tmp_path / "jax" / "0001" / sub,
                          tmp_path / "port" / "0001" / sub)
        assert len(imgs) == 3
    left = read_image(tmp_path / "port" / "0001" / "left" / "0.png")
    right = read_image(tmp_path / "port" / "0001" / "right" / "0.png")
    assert np.abs(left.astype(int) - right.astype(int)).max() > 0
    j, p = manifests["jax"], manifests["port"]
    assert (j.pop("backend"), p.pop("backend")) == ("tile", "kernel")
    assert j == p and p["rendered_this_run"] == 3 and p["n_poses"] == 3
    # resume: the second run renders nothing new
    assert dataset_gen.main(argv + ["--out", str(tmp_path / "port")]
                            + PORT) == 0
    manifest = json.loads(
        (tmp_path / "port" / "0001" / "manifest.json").read_text())
    assert manifest["rendered_this_run"] == 0


def test_render_all_batch(tmp_path, scenes):
    reports = {}
    for name, mod, extra in (("jax", jax_render_all, JAX),
                             ("port", render_all, PORT)):
        report = tmp_path / f"{name}.json"
        rc = mod.main(["--scenes-root", str(scenes),
                       "--out", str(tmp_path / name),
                       "--report", str(report),
                       "--width", "64", "--height", "48"] + extra)
        assert rc == 1  # scene 0003 has no PLY
        reports[name] = json.loads(report.read_text())
    rep = reports["port"]
    assert rep["0001"] == rep["0002"] == "ok"
    assert rep["0003"].startswith("failed: ")
    assert {k: v.split(":")[0] for k, v in rep.items()} == \
        {k: v.split(":")[0] for k, v in reports["jax"].items()}
    for scene in ("0001", "0002"):
        _same_dirs(tmp_path / "jax" / scene / "depth",
                   tmp_path / "port" / scene / "depth")
    # skipping the failing scene gives exit code 0
    assert render_all.main(["--scenes-root", str(scenes),
                            "--out", str(tmp_path / "port"),
                            "--report", str(tmp_path / "skip.json"),
                            "--width", "64", "--height", "48",
                            "--skip", "2"] + PORT) == 0


def test_serve_gs_model(scenes):
    args = serve.build_parser().parse_args(
        ["--gs-model", str(scenes / "0001"), "--width", "96", "--height",
         "64"] + PORT)
    state = serve.build_state(args)
    assert len(state.scene) == 512  # 500 splats padded to 256
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        info = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/info", timeout=60).read())
        assert info["n_gaussians"] == 512 and info["sh_dim"] == 12
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?yaw=0.4&pitch=0.2&mode=sh1",
            timeout=120).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_train_gs_model_scene_dir(tmp_path, scenes, capsys):
    out = tmp_path / "trained.npz"
    rc = train.main(["--gs-model", str(scenes / "0002"), "--self-distill",
                     "--steps", "2", "--width", "48", "--height", "32",
                     "--log-every", "1", "--out", str(out)] + PORT)
    assert rc in (0, 1) and out.exists()
    assert "final_psnr_db" in capsys.readouterr().out
