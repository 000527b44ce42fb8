"""8-bit RGB PNG encoding (PIL where it is installed, else a self-contained
zlib PNG writer, no filtering) and PNG reading (PIL only, as in the JAX
package)."""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PILImage
except ImportError:
    _PILImage = None


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png_raw(arr: np.ndarray) -> bytes:
    """Minimal PNG encoder: uint8 RGB/gray or uint16 gray."""
    h, w = arr.shape[:2]
    if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        color_type, bit_depth = 2, 8
        raw = arr
    elif arr.dtype == np.uint8 and arr.ndim == 2:
        color_type, bit_depth = 0, 8
        raw = arr[..., None]
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        color_type, bit_depth = 0, 16
        raw = arr[..., None].astype(">u2")  # PNG is big-endian
    else:
        raise ValueError(f"unsupported array {arr.dtype} {arr.shape}")
    rows = np.ascontiguousarray(raw).reshape(h, -1).view(np.uint8).reshape(h, -1)
    payload = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows], axis=1
    ).tobytes()  # filter byte 0 before every row
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(payload, 6))
        + _png_chunk(b"IEND", b"")
    )


def encode_rgb8(img) -> bytes:
    """PNG bytes of a float [0,1] or uint8 HxWx3 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(
            np.round(np.asarray(img, np.float32) * 255.0), 0, 255
        ).astype(np.uint8)
    if _PILImage is not None:
        buf = io.BytesIO()
        _PILImage.fromarray(img, mode="RGB").save(buf, format="PNG")
        return buf.getvalue()
    return encode_png_raw(img)


def write_rgb8(path, img) -> None:
    """Save float [0,1] or uint8 HxWx3 as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_rgb8(img))


def read_image(path) -> np.ndarray:
    """Read a PNG as numpy (uint8 HxWx3 or uint16 HxW)."""
    if _PILImage is None:
        raise RuntimeError("PNG reading requires PIL, which is not installed")
    with _PILImage.open(path) as im:
        return np.array(im)
