"""PyTorch port: the serve app answers /info and /render on the CPU."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

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
