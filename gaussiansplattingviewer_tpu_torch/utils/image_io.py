"""Image I/O: 8-bit RGB and 16-bit grayscale PNG read/write.

The JAX package's ``utils/image_io.py`` for the port: the writers take the
native zlib encoder (``csrc/gsv_native.cpp`` through ``native/``) first,
then PIL, then a self-contained zlib writer (no filtering).  Reading
uses PIL.
"""

from __future__ import annotations

import ctypes
import io
import os
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


def _to_rgb8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(
            np.round(np.asarray(img, np.float32) * 255.0), 0, 255
        ).astype(np.uint8)
    return img


def encode_rgb8(img) -> bytes:
    """PNG bytes of a float [0,1] or uint8 HxWx3 image."""
    img = _to_rgb8(img)
    if _PILImage is not None:
        buf = io.BytesIO()
        _PILImage.fromarray(img, mode="RGB").save(buf, format="PNG")
        return buf.getvalue()
    return encode_png_raw(img)


def _native_lib():
    from gaussiansplattingviewer_tpu_torch import native

    return native.get_lib()


def write_rgb8(path, img) -> None:
    """Save float [0,1] or uint8 HxWx3 as an 8-bit RGB PNG (the
    reference's left/right captures, main.py:916-917): the native encoder,
    else PIL, else the numpy writer."""
    img = _to_rgb8(img)
    lib = _native_lib()
    if lib is not None and img.ndim == 3 and img.shape[2] == 3:
        data = np.ascontiguousarray(img)
        if lib.gsv_write_png_rgb8(
                str(path).encode(), img.shape[1], img.shape[0],
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 6) == 0:
            return
    with open(path, "wb") as f:
        f.write(encode_rgb8(img))


def write_disparity16(path, disp) -> None:
    """Save a float disparity map (fraction of image width, [0,1]) as a
    16-bit PNG scaled by 65535, as the reference does (main.py:875-879)."""
    disp16 = np.clip(
        np.asarray(disp, np.float32) * 65535.0, 0, 65535
    ).astype(np.uint16)
    lib = _native_lib()
    if lib is not None:
        data = np.ascontiguousarray(disp16)
        if lib.gsv_write_png_gray16(
                str(path).encode(), disp16.shape[1], disp16.shape[0],
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                6) == 0:
            return
    if _PILImage is not None:
        _PILImage.fromarray(disp16).save(path)  # 16-bit gray PNG
    else:
        with open(path, "wb") as f:
            f.write(encode_png_raw(disp16))


def read_image(path) -> np.ndarray:
    """Read a PNG as numpy (uint8 HxWx3 or uint16 HxW); needs PIL, as in
    the JAX package."""
    if _PILImage is None:
        raise RuntimeError("PNG reading requires PIL, which is not installed")
    with _PILImage.open(path) as im:
        return np.array(im)


def ensure_dirs(*paths) -> None:
    for p in paths:
        os.makedirs(p, exist_ok=True)
