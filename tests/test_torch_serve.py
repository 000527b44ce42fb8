"""PyTorch port: the serve app answers /info and /render on the CPU, and
renders through the backend ``--backend`` names."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from gaussiansplattingviewer_tpu_torch.apps import serve


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_serve_info_and_render():
    args = serve.build_parser().parse_args(
        ["--random-scene", "300", "--width", "96", "--height", "64",
         "--device", "cpu"])
    state = serve.build_state(args)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, ctype, body = _get(port, "/info")
        assert status == 200 and ctype == "application/json"
        info = json.loads(body)
        assert info["n_gaussians"] == 512 and info["sh_dim"] == 48
        for query in ("yaw=0.3&pitch=0.2&mode=sh3",
                      "mode=depth&scale=0.5",
                      "fly=1&px=0&py=0&pz=9&yaw=3.14159&pitch=0"):
            status, ctype, png = _get(port, "/render?" + query)
            assert status == 200 and ctype == "image/png"
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
        status, ctype, page = _get(port, "/")
        assert status == 200 and b"<img id=v" in page
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_backend_oracle_renders_through_the_oracle(monkeypatch):
    """``--backend oracle`` answers /render with the PNG of
    ``render(..., backend="oracle")`` at the same pose, and every render
    the server makes asks for the oracle."""
    from gaussiansplattingviewer_tpu_torch.ops.render import render
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
    from gaussiansplattingviewer_tpu_torch.utils.image_io import encode_rgb8

    args = serve.build_parser().parse_args(
        ["--random-scene", "300", "--width", "96", "--height", "64",
         "--device", "cpu", "--backend", "oracle"])
    state = serve.build_state(args)
    assert state.backend == "oracle"
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
        status, ctype, png = _get(port, "/render?yaw=0.3&pitch=0.2&mode=sh3")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200 and ctype == "image/png"
    assert asked == ["oracle"]
    # the pose render_frame builds for yaw 0.3, pitch 0.2 at the default
    # radius, scale 1
    yaw, pitch = 0.3, 0.2
    front = np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch),
                      np.cos(pitch) * np.cos(yaw)])
    eye = state.center + state.radius * front
    view = tf.look_at(eye, state.center, [0, -1, 0])
    cfg = state.cfg.with_(scale_modifier=1.0)
    proj = Camera(h=cfg.height, w=cfg.width).get_project_matrix()
    img = render(state.scene, view, proj, eye.astype(np.float32), cfg,
                 backend="oracle", device="cpu").numpy()
    assert png == encode_rgb8(img)


def test_serve_rejects_unknown_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.build_parser().parse_args(["--backend", "pallas"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_raw_png_encoder_roundtrip():
    from gaussiansplattingviewer_tpu_torch.utils.image_io import encode_png_raw
    import zlib

    img = np.random.default_rng(0).integers(0, 255, (5, 7, 3), np.uint8)
    png = encode_png_raw(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    idat = png[png.index(b"IDAT") + 4:png.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(5, 1 + 21)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(5, 7, 3), img)


def test_write_rgb8_matches_jax_package(tmp_path):
    from PIL import Image

    from gaussiansplattingviewer_tpu.utils.image_io import (
        write_rgb8 as jax_write_rgb8,
    )
    from gaussiansplattingviewer_tpu_torch.utils.image_io import write_rgb8

    img = np.random.default_rng(1).uniform(-0.1, 1.1, (9, 13, 3))
    write_rgb8(tmp_path / "port.png", img)
    jax_write_rgb8(tmp_path / "jax.png", img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port.png")),
        np.asarray(Image.open(tmp_path / "jax.png")))
