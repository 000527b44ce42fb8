"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` (ignored by
git) the first time it is needed, and loaded with ``ctypes``.  Libraries
are named by a hash of their source, the sources it includes from
``csrc/`` and the flags, so an edited source is rebuilt and a stale one is
never loaded.

Flags: ``-O3`` and ``-fmad=false``, never ``--use_fast_math``.  The blend's
alpha_min, power <= 0 and ball thresholds are discrete, so every product
and sum rounds exactly as the plain PyTorch version's separate operations
do (no FMA contraction) and ``expf`` is the full-precision one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels cannot be built"
        )
    return path


def _source_bytes(path: Path) -> bytes:
    """A source with the sources it includes by ``#include "..."`` from
    ``csrc/``, recursively (a surfel library includes its 3DGS source)."""
    src = path.read_bytes()
    out = [src]
    for inc in re.findall(rb'^#include "([^"]+)"', src, flags=re.M):
        out.append(_source_bytes(path.parent / inc.decode()))
    return b"".join(out)


def _lib_path(name: str) -> Path:
    src = _source_bytes(SRC_DIR / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together.  Returns {name: {"seconds", "log"}} for the sources
    compiled by this call; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    done = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.gsv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gsv_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.gsv_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
