"""ctypes loader for the native host data path (``csrc/gsv_native.cpp``):
the PLY reader behind ``models.ply.load_ply(use_native=True)`` and the PNG
encoders behind ``utils.image_io.write_rgb8`` / ``write_disparity16``.

Built on first use with ``g++ -O3 -shared -fPIC -std=c++17 ... -lz`` into
the package's ``_build/`` directory (ignored by git), named by a hash of
the source and flags so an edited source is rebuilt.  This is host I/O,
not a device kernel: when g++ or zlib is missing, ``get_lib()`` returns
None and every caller falls back to its numpy / PIL path; ``status()``
says which path is in use and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "csrc" / "gsv_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_status = "not loaded yet"


class GsvPlyInfo(ctypes.Structure):
    _fields_ = [
        ("n_vertices", ctypes.c_int64),
        ("n_props", ctypes.c_int32),
        ("sh_rest", ctypes.c_int32),
        ("header_bytes", ctypes.c_int64),
    ]


def lib_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"gsv_native-{digest[:16]}.so"


def _build(out: Path) -> str | None:
    """Compile the library to ``out``; None on success, else the reason."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(SRC), "-lz", "-o", str(tmp)],
            capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ did not run ({e})"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr.strip()[-300:]}"
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.gsv_ply_inspect.restype = ctypes.c_int
    lib.gsv_ply_inspect.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(GsvPlyInfo), ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.gsv_ply_load.restype = ctypes.c_int
    lib.gsv_ply_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, i32p, ctypes.c_int32, i32p, ctypes.c_int32, i32p,
        ctypes.c_int32, f32p, f32p, f32p, f32p, f32p,
    ]
    lib.gsv_write_png_rgb8.restype = ctypes.c_int
    lib.gsv_write_png_rgb8.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]
    lib.gsv_write_png_gray16.restype = ctypes.c_int
    lib.gsv_write_png_gray16.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int32,
    ]
    return lib


def get_lib():
    """The bound library, or None when native support is unavailable."""
    global _lib, _tried, _status
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = lib_path()
        reason = None if out.exists() else _build(out)
        if reason is None:
            try:
                _lib = _bind(ctypes.CDLL(str(out)))
            except OSError as e:
                reason = f"load failed ({e})"
        _status = f"native ({out.name})" if _lib is not None \
            else f"numpy/PIL fallback: {reason}"
        return _lib


def status() -> str:
    """Which host I/O path is in use: the native library or the fallback,
    with the reason."""
    get_lib()
    return _status
