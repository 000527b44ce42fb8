"""PLY scene I/O for official-INRIA-format 3D Gaussian splatting checkpoints.

A numpy copy of the JAX package's ``models/ply.py`` (the port imports
nothing of that package): the same self-contained header parser, the
binary payload decoded with one ``np.frombuffer``, the same field layout
(``x,y,z``, ``opacity``, ``f_dc_0..2``, channel-major ``f_rest_*``
transposed to per-coefficient RGB, ``scale_0..2``, ``rot_0..3``) and the
same activations at load (L2-normalized quaternions, exp(scale),
sigmoid(opacity)), computed in numpy so a load gives bit-identical arrays.

A 2D Gaussian splatting PLY (hbb1/2d-gaussian-splatting) has the same
layout with two scales, ``scale_0`` and ``scale_1``: it loads as a surfel
scene (``scale`` (N, 2)) and a surfel scene saves as one.

``load_ply`` reads the standard binary float layout with the port's
native library (``csrc/gsv_native.cpp`` through ``native/``) and
anything else, or everything when that library is not available, with
numpy.  Both paths apply the activations with the same numpy code, so they
give the same bits.
"""

from __future__ import annotations

import io
import os
import re
from typing import BinaryIO

import numpy as np

from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f: BinaryIO):
    """Parse a PLY header; returns (format, [(elem_name, count, [(prop, dtype)...])])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError(f"not a PLY file (magic={magic!r})")
    fmt = None
    elements = []  # list of [name, count, props]
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append([tokens[1], int(tokens[2]), []])
        elif tokens[0] == "property":
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            elements[-1][2].append((tokens[-1], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "binary_big_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return fmt, elements


def read_ply_vertices(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Read the ``vertex`` element of a PLY file into a dict of 1-D arrays."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = np.loadtxt(
                    io.StringIO(
                        "".join(f.readline().decode("ascii") for _ in range(count))
                    ),
                    dtype=np.float64,
                ).reshape(count, len(props))
                data = {p: rows[:, i] for i, (p, _) in enumerate(props)}
            else:
                endian = "<" if fmt == "binary_little_endian" else ">"
                dt = np.dtype([(p, endian + d) for p, d in props])
                buf = f.read(count * dt.itemsize)
                if len(buf) != count * dt.itemsize:
                    raise ValueError(f"truncated PLY payload for element {name}")
                rec = np.frombuffer(buf, dtype=dt, count=count)
                data = {p: rec[p] for p, _ in props}
            if name == "vertex":
                out = data
            # non-vertex elements are read (to advance the stream) and dropped
        if out is None:
            raise ValueError("PLY file has no 'vertex' element")
        return out


def _numeric_suffix_sorted(names: list[str], prefix: str) -> list[str]:
    """Sort property names by their integer suffix, as the reference does
    with ``sorted(..., key=lambda x: int(x.split('_')[-1]))`` (util_gau.py:93)."""
    sel = [n for n in names if n.startswith(prefix)]
    return sorted(sel, key=lambda n: int(re.split("[_.]", n)[-1]))


def _activations(raw_scale, raw_opacity, raw_rot):
    """exp on scales, sigmoid on opacity, L2-normalize on quaternions (the
    JAX package's numpy path)."""
    scale = np.exp(raw_scale)
    opacity = 1.0 / (1.0 + np.exp(-raw_opacity))
    rot = raw_rot / np.linalg.norm(raw_rot, axis=-1, keepdims=True)
    return scale, opacity, rot


def _inverse_activations(scale, opacity, rot):
    """Inverse of ``_activations`` (for save_ply)."""
    raw_scale = np.log(np.maximum(scale, 1e-12))
    op = np.clip(opacity, 1e-12, 1.0 - 1e-7)
    raw_opacity = np.log(op) - np.log1p(-op)
    return raw_scale, raw_opacity, rot


def _load_ply_native(path, max_sh_degree: int = 3):
    """Single pass of the native reader (csrc/gsv_native.cpp): the file's
    columns, the SH transposed to per-coefficient RGB, then the numpy
    activations.  None when the library or the file's layout is not
    supported (the caller falls back to numpy)."""
    import ctypes

    from gaussiansplattingviewer_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    info = native.GsvPlyInfo()
    max_props = 256
    names_buf = ctypes.create_string_buffer(64 * max_props)
    if lib.gsv_ply_inspect(str(path).encode(), ctypes.byref(info), names_buf,
                           max_props) != 0:
        return None
    names = [names_buf.raw[64 * i:64 * (i + 1)].split(b"\0")[0].decode()
             for i in range(info.n_props)]
    col = {n: i for i, n in enumerate(names)}
    try:
        xyz_idx = [col["x"], col["y"], col["z"]]
        dc_idx = [col[f"f_dc_{i}"] for i in range(3)]
        rest_idx = [col[n] for n in _numeric_suffix_sorted(names, "f_rest_")]
        scale_idx = [col[n] for n in _numeric_suffix_sorted(names, "scale_")]
        rot_idx = [col[n] for n in _numeric_suffix_sorted(names, "rot")]
        op_idx = col["opacity"]
    except KeyError:
        return None
    if len(rest_idx) != info.sh_rest or len(scale_idx) not in (2, 3) \
            or len(rot_idx) != 4:
        return None
    if rest_idx:
        # full bands of a degree the caller takes, else numpy raises
        degree = int(round((len(rest_idx) // 3 + 1) ** 0.5)) - 1
        if len(rest_idx) != 3 * ((degree + 1) ** 2 - 1) \
                or degree > max_sh_degree:
            return None

    n = int(info.n_vertices)
    xyz = np.empty((n, 3), np.float32)
    rot_raw = np.empty((n, 4), np.float32)
    scale_raw = np.empty((n, len(scale_idx)), np.float32)
    opacity_raw = np.empty((n, 1), np.float32)
    sh = np.empty((n, 3 + info.sh_rest), np.float32)

    def i32(a):
        return (ctypes.c_int32 * max(len(a), 1))(*a)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    if lib.gsv_ply_load(
            str(path).encode(), info.header_bytes, n, info.n_props,
            i32(xyz_idx), i32(dc_idx), i32(rest_idx), info.sh_rest,
            i32(scale_idx), len(scale_idx), i32(rot_idx), op_idx, fptr(xyz),
            fptr(rot_raw),
            fptr(scale_raw), fptr(opacity_raw), fptr(sh)) != 0:
        return None
    scale, opacity, rot = _activations(scale_raw, opacity_raw, rot_raw)
    bbox = np.stack([xyz.min(axis=0), xyz.max(axis=0)])
    return GaussianData.from_numpy(xyz, rot, scale, opacity, sh), bbox, \
        xyz.mean(axis=0)


def load_ply(path: str | os.PathLike, max_sh_degree: int = 3,
             use_native: bool = True):
    """Load an INRIA 3DGS checkpoint PLY, or a 2DGS one (two scales: a
    surfel scene).

    Returns ``(GaussianData on the CPU, bbox(2,3), center(3,))`` like the
    reference (util_gau.py:63-125).  SH layout is per-coefficient
    interleaved RGB: ``[dc.rgb, rest_0.rgb, ..., rest_14.rgb]`` — the
    transpose at util_gau.py:99-100 applied to the channel-major on-disk
    layout.  ``use_native`` reads the standard binary float layout with the
    native library where it is available; the result is the same bits as
    the numpy reader's.
    """
    if use_native:
        out = _load_ply_native(path, max_sh_degree)
        if out is not None:
            return out
    v = read_ply_vertices(path)
    names = list(v.keys())
    n = v["x"].shape[0]

    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity_raw = np.asarray(v["opacity"], dtype=np.float32)[:, None]

    bbox = np.stack([xyz.min(axis=0), xyz.max(axis=0)])
    center = xyz.mean(axis=0)

    dc = np.stack(
        [v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1
    ).astype(np.float32)  # (N, 3)

    rest_names = _numeric_suffix_sorted(names, "f_rest_")
    if rest_names:
        # the reference asserts exactly deg-3 (util_gau.py:94); we accept any
        # full-band degree <= max_sh_degree and infer it from the file
        n_rest_coeff = len(rest_names) // 3
        degree = int(round((n_rest_coeff + 1) ** 0.5)) - 1
        expected = 3 * ((degree + 1) ** 2 - 1)
        if len(rest_names) != expected or degree > max_sh_degree:
            raise ValueError(
                f"{len(rest_names)} f_rest properties are not the full bands "
                f"of an SH degree <= {max_sh_degree}")
        rest = np.stack([v[nm] for nm in rest_names], axis=1).astype(np.float32)
        # on-disk layout is channel-major (3, n_coeff); transpose to
        # per-coefficient RGB (util_gau.py:98-100)
        n_coeff = len(rest_names) // 3
        rest = rest.reshape(n, 3, n_coeff).transpose(0, 2, 1).reshape(n, -1)
        sh = np.concatenate([dc, rest], axis=1)
    else:
        sh = dc

    scale_names = _numeric_suffix_sorted(names, "scale_")
    if len(scale_names) not in (2, 3):
        raise ValueError(f"{len(scale_names)} scale properties: a 3DGS PLY "
                         f"has 3, a 2DGS PLY 2")
    scale_raw = np.stack([v[nm] for nm in scale_names], axis=1).astype(np.float32)
    rot_names = _numeric_suffix_sorted(names, "rot")
    rot_raw = np.stack([v[nm] for nm in rot_names], axis=1).astype(np.float32)

    scale, opacity, rot = _activations(scale_raw, opacity_raw, rot_raw)
    scene = GaussianData.from_numpy(xyz, rot, scale, opacity, sh)
    return scene, bbox, center


def save_ply(scene: GaussianData, path: str | os.PathLike) -> None:
    """Write a GaussianData scene as an official-format binary PLY
    (inverse-activated, channel-major f_rest) so it round-trips through
    ``load_ply`` and is readable by the reference and the INRIA tools."""
    host = {f: getattr(scene, f).detach().cpu().numpy()
            for f in ("xyz", "rot", "scale", "opacity", "sh")}
    n = len(scene)
    sh = host["sh"].astype(np.float32)
    dc = sh[:, :3]
    rest = sh[:, 3:]
    n_coeff = rest.shape[1] // 3
    # per-coefficient RGB -> channel-major (inverse of util_gau.py:99-100)
    rest_cm = rest.reshape(n, n_coeff, 3).transpose(0, 2, 1).reshape(n, -1)

    raw_scale, raw_opacity, rot = _inverse_activations(
        host["scale"], host["opacity"], host["rot"]
    )

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(rest_cm.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(host["scale"].shape[1])]
        + [f"rot_{i}" for i in range(4)]
    )
    cols = np.concatenate(
        [
            host["xyz"].astype(np.float32),
            np.zeros((n, 3), np.float32),  # normals, zero like INRIA
            dc,
            rest_cm,
            raw_opacity.astype(np.float32),
            raw_scale.astype(np.float32),
            rot.astype(np.float32),
        ],
        axis=1,
    ).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in props]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(cols).tobytes())
