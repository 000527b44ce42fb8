"""Per-Gaussian projection: culling, EWA 3D->2D covariance, conic, SH color.

A torch copy of the JAX package's projection with the same order of
operations and the same constants: the 1.3x fov clamp, the +0.3 px
low-pass, the |ndc| > 1.3 cull, the 3-sigma quad extent, and DEPTH mode's
x1.2 scale inflate and baseline-shift disparity.  On a CUDA device
``project`` runs the same arithmetic as two hand-written kernels
(``ops/kernels/projection.py``); ``_project`` is the plain version.

Frames: p_clip = P @ V @ p_world (math matrices); the image frame is x
right, y DOWN, origin at the top-left pixel corner; the conic is stored in
that y-down frame.

A surfel scene (2D Gaussian splatting, ``scale`` (N, 2)) projects to the
homography T of each disk instead of a conic (``_project_surfel``; on the
card kernel P1s, ``ops/kernels/projection.py`` ``project_surfel_fwd``).
Its fragments have no gradient yet: ``project`` raises for a surfel scene
whose leaves require grad while grad mode is on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops.kernels.projection import (
    ProjectKernels,
    project_surfel_fwd,
)
from gaussiansplattingviewer_tpu_torch.ops.sh import eval_sh_color
from gaussiansplattingviewer_tpu_torch.utils import profiling
from gaussiansplattingviewer_tpu_torch.utils.transforms import quat_to_rotmat

_PROJ_FIELDS = ("mean2d", "depth", "conic", "radius", "color", "opacity",
                "valid")
# 2DGS (Huang et al. 2024, hbb1/diff-surfel-rasterization): the cutoff of
# the bounding ellipse (3 sigma) and the screen low-pass's sigma
SURFEL_CUTOFF = 3.0
SURFEL_FILTER = 0.7071067811865476  # sqrt(2) / 2


@dataclasses.dataclass
class ProjectedSplats:
    """Screen-space splats, the contract between projection and binning.

      mean2d: (N, 2) pixel-space center (x right, y down).
      depth:  (N,) positive view-space distance; smaller = nearer.
      conic:  (N, 3) inverse 2D covariance (A, B, C), y-down frame;
              power = -0.5*(A dx^2 + C dy^2) - B dx dy.
      radius: (N, 2) 3-sigma half-extents in pixels.
      color:  (N, 3) RGB (disparity replicated to gray in DEPTH mode).
      opacity:(N,) splat opacity.
      valid:  (N,) bool — in-frustum, non-degenerate, non-padding.
      transform: (N, 9) of a surfel scene, else None: the rows Tu, Tv, Tw
              of the homography from the disk's (u, v, 1) to the pixel
              (x w, y w, w); mean2d is then the centre of the disk's
              projected 3-sigma ellipse, radius its half-extent (both
              columns equal) and conic None.
    """

    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor | None
    radius: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor
    transform: torch.Tensor | None = None

    @property
    def surfel(self) -> bool:
        """Surfels (2DGS): a homography per splat instead of a conic."""
        return self.transform is not None

    @classmethod
    def from_numpy(cls, device="cpu", **arrays) -> "ProjectedSplats":
        """From numpy fields (e.g. another package's projection output)."""
        return cls(**{
            k: torch.from_numpy(np.array(arrays[k])).to(device)
            for k in _PROJ_FIELDS
        })


def compute_cov3d(scale: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = R diag(s^2) R^T, (N, 3, 3), for (N, 3) scales
    and (N, 4) wxyz quaternions: the JAX package's ``compute_cov3d``, in its
    expression order (the rotation, the squared scales, one contraction over
    k of R_ik s2_k R_jk)."""
    R = quat_to_rotmat(rot)  # (N, 3, 3)
    s2 = scale * scale  # (N, 3)
    return torch.einsum("nik,nk,njk->nij", R, s2, R)


def compute_cov3d_packed(scale: torch.Tensor, rot: torch.Tensor):
    """Sigma = R diag(s^2) R^T as its 6 unique entries
    (s00, s01, s02, s11, s12, s22), each (N,)."""
    s2 = scale * scale
    s2x, s2y, s2z = s2[:, 0], s2[:, 1], s2[:, 2]
    w, x, y, z = rot[..., 0], rot[..., 1], rot[..., 2], rot[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s00 = s2x * r00 * r00 + s2y * r01 * r01 + s2z * r02 * r02
    s01 = s2x * r00 * r10 + s2y * r01 * r11 + s2z * r02 * r12
    s02 = s2x * r00 * r20 + s2y * r01 * r21 + s2z * r02 * r22
    s11 = s2x * r10 * r10 + s2y * r11 * r11 + s2z * r12 * r12
    s12 = s2x * r10 * r20 + s2y * r11 * r21 + s2z * r12 * r22
    s22 = s2x * r20 * r20 + s2y * r21 * r21 + s2z * r22 * r22
    return s00, s01, s02, s11, s12, s22


def compute_cov2d(mean_view, cov3d, view, focal, tan_fovx, tan_fovy):
    """EWA: clamp the view ray to 1.3x the fov tangents, build the
    perspective Jacobian J, cov2d = J W Sigma W^T J^T, add the +0.3 px
    low-pass.  ``cov3d`` is the packed 6-tuple; ``view`` a (4,4) tensor.
    Returns (N, 3): (cov_xx, cov_xy, cov_yy) in the GL frame (y up)."""
    tx, ty, tz = mean_view[..., 0], mean_view[..., 1], mean_view[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tz_safe = torch.where(torch.abs(tz) < 1e-8, torch.full_like(tz, 1e-8), tz)
    # jnp.clip = minimum(maximum(x, lo), hi), with its half gradients at a
    # tie (torch.clamp passes the whole gradient there)
    tx = torch.minimum(torch.maximum(tx / tz_safe, -limx), limx) * tz_safe
    ty = torch.minimum(torch.maximum(ty / tz_safe, -limy), limy) * tz_safe

    inv_tz = 1.0 / tz_safe
    inv_tz2 = inv_tz * inv_tz
    j00 = focal * inv_tz
    j02 = -focal * tx * inv_tz2
    j11 = focal * inv_tz
    j12 = -focal * ty * inv_tz2

    w00, w01, w02 = view[0, 0], view[0, 1], view[0, 2]
    w10, w11, w12 = view[1, 0], view[1, 1], view[1, 2]
    w20, w21, w22 = view[2, 0], view[2, 1], view[2, 2]
    t00 = j00 * w00 + j02 * w20
    t01 = j00 * w01 + j02 * w21
    t02 = j00 * w02 + j02 * w22
    t10 = j11 * w10 + j12 * w20
    t11 = j11 * w11 + j12 * w21
    t12 = j11 * w12 + j12 * w22

    s00, s01, s02, s11, s12, s22 = cov3d
    cxx = (
        t00 * t00 * s00 + t01 * t01 * s11 + t02 * t02 * s22
        + 2.0 * (t00 * t01 * s01 + t00 * t02 * s02 + t01 * t02 * s12)
    ) + 0.3
    cyy = (
        t10 * t10 * s00 + t11 * t11 * s11 + t12 * t12 * s22
        + 2.0 * (t10 * t11 * s01 + t10 * t12 * s02 + t11 * t12 * s12)
    ) + 0.3
    cxy = (
        t00 * t10 * s00 + t01 * t11 * s11 + t02 * t12 * s22
        + (t00 * t11 + t01 * t10) * s01
        + (t00 * t12 + t02 * t10) * s02
        + (t01 * t12 + t02 * t11) * s12
    )
    return torch.stack([cxx, cxy, cyy], dim=-1)


def project(scene: GaussianData, view, proj, cam_pos,
            cfg: RenderConfig) -> ProjectedSplats:
    """Project a scene into screen space.

    view, proj: (4,4) math-convention matrices; cam_pos: (3,) world camera
    position for the SH view directions.  Matrices may be numpy or tensors;
    they are moved to the scene's device.  A scene on a CUDA device goes
    through kernels P1 and P2 (``ops/kernels/projection.py``), one on the
    CPU through the plain ``_project``; a surfel scene through P1s or
    ``_project_surfel``.  Span ``project``; while recording, the scene's
    gradients close span ``project_bwd``.  Counter
    ``project.surfel_splats``: the surfels a surfel scene projects.
    """
    if scene.surfel:
        check_surfel_no_grad(scene)
    with profiling.span("project", scene.xyz.device):
        if scene.surfel:
            profiling.count("project.surfel_splats", len(scene))
            if scene.xyz.device.type == "cuda":
                return _project_surfel_kernel(scene, view, proj, cam_pos,
                                              cfg)
            return _project_surfel(scene, view, proj, cam_pos, cfg)
        if profiling.recording():
            scene = GaussianData(*profiling.close_in_backward(
                "project_bwd", (scene.xyz, scene.rot, scene.scale,
                                scene.opacity, scene.sh)))
        if scene.xyz.device.type == "cuda":
            return _project_kernels(scene, view, proj, cam_pos, cfg)
        return _project(scene, view, proj, cam_pos, cfg)


def check_surfel_no_grad(scene: GaussianData) -> None:
    """Raise for a surfel scene on the card that autograd would
    differentiate: the card has no 2DGS backward kernels, so its render
    never returns gradients there.  On the CPU autograd differentiates the
    plain versions (projection and every blend executor)."""
    if scene.xyz.device.type != "cpu" and torch.is_grad_enabled() and any(
            getattr(scene, f).requires_grad
            for f in ("xyz", "rot", "scale", "opacity", "sh")):
        raise NotImplementedError(
            "2D Gaussian splatting (a scene with two scales per splat) "
            "renders on the card without gradients only: 2DGS training is "
            "not yet ported to its kernels; render under torch.no_grad(), "
            "detach the leaves or train on the CPU")


def _surfel_mode(cfg: RenderConfig) -> int:
    mode = int(cfg.mode)
    if mode < int(RenderMode.DEPTH):
        raise ValueError(
            f"a surfel (2DGS) scene renders in the SH and DEPTH modes only, "
            f"not {RenderMode(mode).name}")
    return mode


def _project_surfel_kernel(scene: GaussianData, view, proj, cam_pos,
                           cfg: RenderConfig) -> ProjectedSplats:
    f32 = torch.float32
    dev = scene.xyz.device
    _surfel_mode(cfg)
    leaves = [a.to(f32).contiguous() for a in (
        scene.xyz, scene.rot, scene.scale, scene.opacity, scene.sh)]
    camera = [torch.as_tensor(m, dtype=f32, device=dev).contiguous()
              for m in (view, proj, cam_pos)]
    mean2d, depth, transform, radius, color, valid = project_surfel_fwd(
        *leaves, *camera, cfg)
    return ProjectedSplats(mean2d=mean2d, depth=depth, conic=None,
                           radius=radius, color=color,
                           opacity=leaves[3][..., 0], valid=valid,
                           transform=transform)


def _surfel_homography(xyz, rot, scale, view, proj, clip, width, height):
    """The rows Tu, Tv, Tw (N, 3) each of H = M [[s_u r1, s_v r2, mu],
    [0, 0, 1]]: M maps a world point to (x w, y w, w) in pixels (P V, then
    the pixel map of ``mean2d``), so H's columns are the images of the
    disk's two scaled tangent axes (directions, w = 0) and of its centre
    (``clip``, its clip coordinates).  Kernel P1s computes the same
    expressions in the same order."""
    w, x, y, z = rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]
    # the rotation's first two columns, as quat_to_rotmat writes them
    r1 = (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + w * z),
          2.0 * (x * z - w * y))
    r2 = (2.0 * (x * y - w * z), 1.0 - 2.0 * (x * x + z * z),
          2.0 * (y * z + w * x))
    half_w, half_h = 0.5 * width, 0.5 * height

    def image(d):  # a world direction -> (x w, y w, w)
        v = [d[0] * view[k, 0] + d[1] * view[k, 1] + d[2] * view[k, 2]
             for k in range(3)]
        c = [v[0] * proj[k, 0] + v[1] * proj[k, 1] + v[2] * proj[k, 2]
             for k in (0, 1, 3)]
        return (c[0] + c[2]) * half_w, (c[2] - c[1]) * half_h, c[2]

    su, sv = scale[:, 0], scale[:, 1]
    hu = image([a * su for a in r1])
    hv = image([a * sv for a in r2])
    hm = ((clip[:, 0] + clip[:, 3]) * half_w,
          (clip[:, 3] - clip[:, 1]) * half_h, clip[:, 3])
    return [torch.stack([hu[k], hv[k], hm[k]], dim=-1) for k in range(3)]


def surfel_bound(tu, tv, tw):
    """The centre (N, 2) and half-extents (N, 2) of the disk's projected
    3-sigma ellipse, from its dual conic (the official rasterizer's
    ``compute_aabb``), and whether it exists (d != 0).  Sums are written
    out left to right, as kernel P1s takes them."""
    t = (SURFEL_CUTOFF ** 2, SURFEL_CUTOFF ** 2, -1.0)

    def dot(f, p, q):  # sum_k f_k p_k q_k
        return f[0] * p[:, 0] * q[:, 0] + f[1] * p[:, 1] * q[:, 1] \
            + f[2] * p[:, 2] * q[:, 2]

    d = dot(t, tw, tw)
    ok = d != 0.0
    ds = torch.where(ok, d, torch.ones_like(d))
    f = [torch.full_like(ds, tk) / ds for tk in t]
    cx, cy = dot(f, tu, tw), dot(f, tv, tw)
    hx = cx * cx - dot(f, tu, tu)
    hy = cy * cy - dot(f, tv, tv)
    extent = torch.sqrt(torch.clamp(torch.stack([hx, hy], dim=-1),
                                    min=1e-4))
    return torch.stack([cx, cy], dim=-1), extent, ok


def _project_surfel(scene: GaussianData, view, proj, cam_pos,
                    cfg: RenderConfig) -> ProjectedSplats:
    """The plain projection of a surfel scene: the culls, depth, opacity
    and colour of ``_project`` with the homography T in place of the
    conic, the 3-sigma ellipse's centre as mean2d and its bound as the
    radius (ceil(max(extent_x, extent_y, 3 sqrt(2) / 2)))."""
    f32 = torch.float32
    dev = scene.xyz.device
    mode = _surfel_mode(cfg)
    xyz = scene.xyz.to(f32)
    n = xyz.shape[0]
    view = torch.as_tensor(view, dtype=f32, device=dev)
    proj = torch.as_tensor(proj, dtype=f32, device=dev)
    cam_pos = torch.as_tensor(cam_pos, dtype=f32, device=dev)

    mean_view = xyz @ view[:3, :3].T + view[:3, 3]
    pv_h = torch.cat([mean_view, torch.ones((n, 1), dtype=f32, device=dev)],
                     dim=-1)
    clip = pv_h @ proj.T
    w = clip[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[..., :3] / w_safe[..., None]
    lim = cfg.ndc_cull_limit
    in_frustum = torch.all(torch.abs(ndc) <= lim, dim=-1) & (w > 1e-8)
    not_padding = scene.opacity[..., 0] > 0.0

    scale_mult = cfg.scale_modifier * (
        cfg.depth_scale_inflate if mode == RenderMode.DEPTH else 1.0)
    tu, tv, tw = _surfel_homography(
        xyz, scene.rot.to(f32), scene.scale.to(f32) * scale_mult, view, proj,
        clip, float(cfg.width), float(cfg.height))
    center, extent, ok = surfel_bound(tu, tv, tw)
    r = torch.ceil(torch.maximum(
        torch.maximum(extent[:, 0], extent[:, 1]),
        torch.full_like(extent[:, 0], SURFEL_CUTOFF * SURFEL_FILTER)))

    if mode == RenderMode.DEPTH:
        color = _disparity_color(xyz, view, proj, cfg, ndc)
    else:
        dir = xyz - cam_pos
        norm = torch.linalg.norm(dir, dim=-1, keepdim=True)
        dir = dir / torch.maximum(norm, torch.full_like(norm, 1e-12))
        color = eval_sh_color(scene.sh.to(f32), dir, mode,
                              clamp=cfg.clamp_color)
    return ProjectedSplats(
        mean2d=center,
        depth=-mean_view[..., 2],
        conic=None,
        radius=torch.stack([r, r], dim=-1),
        color=color,
        opacity=scene.opacity[..., 0].to(f32),
        valid=in_frustum & ok & not_padding,
        transform=torch.cat([tu, tv, tw], dim=-1),
    )


def _project_kernels(scene: GaussianData, view, proj, cam_pos,
                     cfg: RenderConfig) -> ProjectedSplats:
    f32 = torch.float32
    dev = scene.xyz.device
    leaves = [a.to(f32).contiguous() for a in (
        scene.xyz, scene.rot, scene.scale, scene.opacity, scene.sh)]
    camera = [torch.as_tensor(m, dtype=f32, device=dev).contiguous()
              for m in (view, proj, cam_pos)]
    mean2d, depth, conic, radius, color, valid = ProjectKernels.apply(
        *leaves, *camera, cfg)
    return ProjectedSplats(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        radius=radius,
        color=color,
        opacity=scene.opacity[..., 0].to(f32),
        valid=valid,
    )


def _project(scene: GaussianData, view, proj, cam_pos,
             cfg: RenderConfig) -> ProjectedSplats:
    f32 = torch.float32
    dev = scene.xyz.device
    xyz = scene.xyz.to(f32)
    n = xyz.shape[0]
    view = torch.as_tensor(view, dtype=f32, device=dev)
    proj = torch.as_tensor(proj, dtype=f32, device=dev)
    cam_pos = torch.as_tensor(cam_pos, dtype=f32, device=dev)
    mode = int(cfg.mode)

    mean_view = xyz @ view[:3, :3].T + view[:3, 3]
    pv_h = torch.cat([mean_view, torch.ones((n, 1), dtype=f32, device=dev)],
                     dim=-1)
    clip = pv_h @ proj.T
    w = clip[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[..., :3] / w_safe[..., None]

    lim = cfg.ndc_cull_limit
    in_frustum = torch.all(torch.abs(ndc) <= lim, dim=-1) & (w > 1e-8)
    not_padding = scene.opacity[..., 0] > 0.0

    scale_mult = cfg.scale_modifier * (
        cfg.depth_scale_inflate if mode == RenderMode.DEPTH else 1.0
    )
    cov3d = compute_cov3d_packed(
        scene.scale.to(f32) * scale_mult, scene.rot.to(f32)
    )
    htanx, htany = 1.0 / proj[0, 0], 1.0 / proj[1, 1]
    # focal in pixels h / (2 tan(fovy/2)), used for both axes
    focal = cfg.height / (2.0 * htany)
    cov2d = compute_cov2d(mean_view, cov3d, view, focal, htanx, htany)
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]

    det = cxx * cyy - cxy * cxy
    nondegenerate = det > 0.0
    det_safe = torch.where(nondegenerate, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    # y-DOWN image frame: flipping y negates the cross term
    conic = torch.stack([cyy * inv_det, cxy * inv_det, cxx * inv_det], dim=-1)

    W, H = float(cfg.width), float(cfg.height)
    mean_px = torch.stack(
        [(ndc[..., 0] + 1.0) * 0.5 * W, (1.0 - ndc[..., 1]) * 0.5 * H],
        dim=-1,
    )
    zero = torch.zeros_like(cxx)
    radius = torch.stack(
        [3.0 * torch.sqrt(torch.maximum(cxx, zero)),
         3.0 * torch.sqrt(torch.maximum(cyy, zero))],
        dim=-1,
    )

    if mode == RenderMode.DEPTH:
        color = _disparity_color(xyz, view, proj, cfg, ndc)
    else:
        dir = xyz - cam_pos
        norm = torch.linalg.norm(dir, dim=-1, keepdim=True)
        dir = dir / torch.maximum(norm, torch.full_like(norm, 1e-12))
        color = eval_sh_color(scene.sh.to(f32), dir, mode,
                              clamp=cfg.clamp_color)

    depth = -mean_view[..., 2]
    valid = in_frustum & nondegenerate & not_padding
    return ProjectedSplats(
        mean2d=mean_px,
        depth=depth,
        conic=conic,
        radius=radius,
        color=color,
        opacity=scene.opacity[..., 0].to(f32),
        valid=valid,
    )


def _disparity_color(xyz, view, proj, cfg: RenderConfig, ndc_left):
    """Per-splat stereo disparity as gray: project the center and the center
    shifted by ``stereo_baseline`` along world x; disparity =
    |x_l - x_r| in units of the image width."""
    shift = torch.tensor([cfg.stereo_baseline, 0.0, 0.0], dtype=xyz.dtype,
                         device=xyz.device)
    p_r = xyz + shift
    mv_r = p_r @ view[:3, :3].T + view[:3, 3]
    clip_r = torch.cat([mv_r, torch.ones_like(mv_r[..., :1])], dim=-1) @ proj.T
    w_r = clip_r[..., 3]
    w_r = torch.where(torch.abs(w_r) < 1e-8, torch.full_like(w_r, 1e-8), w_r)
    x_ndc_r = clip_r[..., 0] / w_r
    x_pix_l = (ndc_left[..., 0] + 1.0) * 0.5
    x_pix_r = (x_ndc_r + 1.0) * 0.5
    d = torch.abs(x_pix_l - x_pix_r)
    return torch.stack([d, d, d], dim=-1)
