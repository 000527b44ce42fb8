"""Kernels P1 and P2: projection and SH colour of every splat, forward and
backward, hand-written in CUDA for Hopper (``csrc/projection.cu``).

They replace no Pallas kernel: the JAX package projects in XLA
(``gaussiansplattingviewer_tpu/ops/projection.py``), and its plain PyTorch
port, ``ops/projection.py`` ``_project``, stays the CPU path and the
yardstick the kernels are held to on the card.  ``ProjectKernels`` wraps
the pair in a ``torch.autograd.Function``: P1 computes the whole of
``_project`` (cull, 3D and 2D covariance, conic, pixel centre, radius,
SH or disparity colour) in one launch; P2, from the inputs and the
cotangents of the five float outputs alone (no saved intermediates),
writes the gradients of xyz, rot, scale and sh, each once.  The header of
the source says what bounds them (memory: ~236 B read per splat) and what
the design does about that.

P1s (``project_surfel_fwd``, ``csrc/projection_surfel.cu``, its own
library, so a 3DGS scene never builds or loads it) is P1 for a surfel
scene (2D Gaussian splatting, two scales per splat): ``_project``'s culls,
depth and colour, and in place of the conic the disk's homography T and
its 3-sigma ellipse's centre and bound (``ops/projection.py``
``_project_surfel``, the plain version).  It has no backward yet.

Each wrapper takes CUDA tensors only and raises on anything else; there is
no CPU mode (``ops/projection.py`` runs the plain version for CPU
tensors).  Launches are counted in ``project_fwd.launches``,
``project_bwd.launches`` and ``project_surfel_fwd.launches``; while
recording, each forward adds its splats to the counter
``project.kernel_splats`` (``ops/projection.py`` counts a surfel scene's
in ``project.surfel_splats`` on any device).
"""

from __future__ import annotations

import ctypes

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops.kernels import build
from gaussiansplattingviewer_tpu_torch.ops.sh import used_degree
from gaussiansplattingviewer_tpu_torch.utils import profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# inputs shared by both entry points: the leaves, the SH width and count,
# degree, DEPTH flag, the camera and the scalars of RenderConfig
_IN_TYPES = [_P] * 5 + [_I] * 4 + [_P] * 3 + [_F] * 5 + [_I]
# then P1: its six outputs and the stream; P2: the five cotangents, the
# four gradients, the stream
_ARGTYPES = {"gsv_project_fwd": _IN_TYPES + [_P] * 6 + [_P],
             "gsv_project_bwd": _IN_TYPES + [_P] * 5 + [_P] * 4 + [_P],
             "gsv_project_surfel_fwd": _IN_TYPES + [_P] * 6 + [_P]}
_LEAF_COLS = {"xyz": 3, "rot": 4, "scale": 3, "opacity": 1}
_COT_SHAPES = ((2,), (), (3,), (2,), (3,))  # per splat, P1's float outputs
_FNS: dict = {}


def check_inputs(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                 n_scale: int = 3):
    """Raise unless the kernels take these tensors: float32, contiguous,
    xyz (N, 3), rot (N, 4), scale (N, n_scale) (3; P1s 2), opacity
    (N, 1), sh (N, K), view and proj (4, 4), cam_pos (3,), all on one CUDA
    device."""
    leaves = dict(xyz=xyz, rot=rot, scale=scale, opacity=opacity, sh=sh,
                  view=view, proj=proj, cam_pos=cam_pos)
    n = xyz.shape[0] if xyz.dim() == 2 else -1
    shapes = {k: (n, c) for k, c in _LEAF_COLS.items()}
    shapes["scale"] = (n, n_scale)
    shapes.update(sh=(n, sh.shape[-1]), view=(4, 4), proj=(4, 4),
                  cam_pos=(3,))
    for name, t in leaves.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xyz.device.type != "cuda":
        raise ValueError(f"the projection kernels take CUDA tensors, got "
                         f"{xyz.device} (ops/projection.py runs the plain "
                         f"version for CPU tensors)")
    if any(t.device != xyz.device for t in leaves.values()):
        raise ValueError("the inputs must share one device")


def _in_args(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
             cfg: RenderConfig):
    depth_mode = cfg.mode == RenderMode.DEPTH
    degree = 0 if depth_mode else used_degree(int(cfg.mode), sh.shape[1])
    if degree < 0 or 3 * (degree + 1) ** 2 > sh.shape[1]:
        raise ValueError(f"sh width {sh.shape[1]} holds no SH degree the "
                         f"colour can use")
    scale_mult = cfg.scale_modifier * (
        cfg.depth_scale_inflate if depth_mode else 1.0)
    return [xyz.data_ptr(), rot.data_ptr(), scale.data_ptr(),
            opacity.data_ptr(), sh.data_ptr(), sh.shape[1], xyz.shape[0],
            degree, int(depth_mode), view.data_ptr(), proj.data_ptr(),
            cam_pos.data_ptr(), float(cfg.width), float(cfg.height),
            scale_mult, cfg.ndc_cull_limit, cfg.stereo_baseline,
            int(cfg.clamp_color)]


def _launch(symbol, args, dev, what, source="projection"):
    """Call ``symbol`` of ``csrc/<source>.cu`` on the current stream of
    ``dev``; its ctypes prototype is set once."""
    lib = build.load(source)
    fn = _FNS.get((lib._name, symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = _I
        _FNS[lib._name, symbol] = fn
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, what)


def project_fwd(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                cfg: RenderConfig):
    """Kernel P1: ``_project``'s mean2d (N, 2), depth (N,), conic (N, 3),
    radius (N, 2), color (N, 3), all float32, and valid (N,) bool."""
    check_inputs(xyz, rot, scale, opacity, sh, view, proj, cam_pos)
    n, dev = xyz.shape[0], xyz.device
    outs = [torch.empty((n, c) if c > 1 else (n,), dtype=torch.float32,
                        device=dev) for c in (2, 1, 3, 2, 3)]
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("gsv_project_fwd",
                _in_args(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                         cfg) + [o.data_ptr() for o in (*outs, valid)],
                dev, "gsv_project_fwd launch")
        project_fwd.launches += 1
        profiling.count("project.kernel_splats", n)
    return (*outs, valid)


project_fwd.launches = 0


def project_bwd(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                cfg: RenderConfig, grads):
    """Kernel P2: the gradients of xyz, rot, scale and sh (None in DEPTH
    mode, whose colour reads no SH) from ``grads``, the cotangents of
    P1's mean2d, depth, conic, radius and color (None counts as zero)."""
    check_inputs(xyz, rot, scale, opacity, sh, view, proj, cam_pos)
    n, dev = xyz.shape[0], xyz.device
    cots = []
    for g, tail in zip(grads, _COT_SHAPES):
        if g is not None and (tuple(g.shape) != (n, *tail)
                              or g.device != dev):
            raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} "
                             f"does not match {(n, *tail)} on {dev}")
        cots.append(None if g is None
                    else g.to(torch.float32).contiguous())
    outs = [torch.empty_like(t) for t in (xyz, rot, scale)]
    depth_mode = cfg.mode == RenderMode.DEPTH
    g_sh = None if depth_mode else torch.empty_like(sh)
    if n:
        _launch("gsv_project_bwd",
                _in_args(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                         cfg)
                + [None if g is None else g.data_ptr() for g in cots]
                + [o.data_ptr() for o in outs]
                + [None if g_sh is None else g_sh.data_ptr()],
                dev, "gsv_project_bwd launch")
        project_bwd.launches += 1
    return (*outs, g_sh)


project_bwd.launches = 0


def project_surfel_fwd(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                       cfg: RenderConfig):
    """Kernel P1s: ``_project_surfel``'s mean2d (N, 2), depth (N,),
    transform (N, 9), radius (N, 2), color (N, 3), all float32, and valid
    (N,) bool, for a surfel scene (scale (N, 2))."""
    check_inputs(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                 n_scale=2)
    n, dev = xyz.shape[0], xyz.device
    outs = [torch.empty((n, c) if c > 1 else (n,), dtype=torch.float32,
                        device=dev) for c in (2, 1, 9, 2, 3)]
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("gsv_project_surfel_fwd",
                _in_args(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                         cfg) + [o.data_ptr() for o in (*outs, valid)],
                dev, "gsv_project_surfel_fwd launch", "projection_surfel")
        project_surfel_fwd.launches += 1
        profiling.count("project.kernel_splats", n)
    return (*outs, valid)


project_surfel_fwd.launches = 0


class ProjectKernels(torch.autograd.Function):
    """P1 forward, P2 backward, on CUDA tensors as ``check_inputs``
    describes: ``ProjectKernels.apply(xyz, rot, scale, opacity, sh, view,
    proj, cam_pos, cfg)`` gives (mean2d, depth, conic, radius, color,
    valid), the fields of ``ProjectedSplats`` but opacity.  Saves only the
    inputs and the camera."""

    @staticmethod
    def forward(ctx, xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(xyz, rot, scale, opacity, sh, view, proj,
                              cam_pos)
        ctx.set_materialize_grads(False)
        out = project_fwd(xyz, rot, scale, opacity, sh, view, proj, cam_pos,
                          cfg)
        ctx.mark_non_differentiable(out[-1])
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, g_radius, g_color,
                 _g_valid):
        grads = (g_mean2d, g_depth, g_conic, g_radius, g_color)
        if all(g is None for g in grads):
            return (None,) * 9
        g_xyz, g_rot, g_scale, g_sh = project_bwd(
            *ctx.saved_tensors, ctx.cfg, grads)
        need = ctx.needs_input_grad
        return (g_xyz if need[0] else None, g_rot if need[1] else None,
                g_scale if need[2] else None, None,
                g_sh if need[4] else None, None, None, None, None)
