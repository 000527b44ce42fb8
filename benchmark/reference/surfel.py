"""Plain PyTorch reference of 2D Gaussian splatting (2DGS: Huang, Yu, Chen,
Geiger and Gao, SIGGRAPH 2024, arXiv:2403.17888; the official rasterizer
is hbb1/diff-surfel-rasterization), the primitive that a configuration
names with ``"reference": "surfel"``: the scene, the render, its loss
gradient and the optimizer step that the benchmark holds the program's
timed path to, and the work they need (``cells.py`` gives the contract of
such a module).

It imports nothing of the program and takes nothing the program made.
From ``splat.py`` (3DGS) it takes what applies unchanged: the SH colour,
the rotation of a quaternion as stored, the TF32 rounding of the control,
the tile binning (16-px tiles, rows ordered by (the top bits of the
float32 depth pattern, splat index), the depth field as wide as 32 bits
less the bits of (tiles + 1)) and the SGD step.

A surfel is a flat disk: centre mu, rotation R = R(q) with columns r1, r2,
r3, two tangent scales (s_u, s_v), an opacity and SH colour.  Definition:

* The homography.  M maps a world point to homogeneous pixel coordinates
  (x w, y w, w): P V, then the pixel map of a 3DGS centre, x = (ndc_x + 1)
  W / 2 and y = (1 - ndc_y) H / 2.  H = M [[s_u r1, s_v r2, mu], [0, 0,
  1]] maps the disk's (u, v, 1) there; Tu, Tv, Tw are its rows.
* A fragment at the pixel centre (x, y) (pixel index + 0.5): p = (x Tw -
  Tu) x (y Tw - Tv), skipped where p3 = 0; (u, v) = (p1 / p3, p2 / p3),
  rho3d = u^2 + v^2; the low-pass rho2d = 2 ((x - cx)^2 + (y - cy)^2)
  (sigma = sqrt(2) / 2); rho = min(rho3d, rho2d).  The ray meets the
  disk's plane at depth u Tw1 + v Tw2 + Tw3 where rho3d <= rho2d, else
  Tw3; the fragment is skipped where that is under 0.2 (the published
  near test).  alpha = min(0.99, opacity exp(-rho / 2)), kept where at
  least 1/255; front-to-back compositing, background 0.
* Centre and bound, the official ``compute_aabb`` (the projected 3-sigma
  ellipse, from its dual conic): t = (9, 9, -1), d = sum t Tw^2 (d = 0: the
  surfel is invalid), c = (sum t Tu Tw, sum t Tv Tw) / d, e = sqrt(max(1e-4,
  c^2 - (sum t Tu^2, sum t Tv^2) / d)), radius = ceil(max(e_x, e_y, 3
  sqrt(2) / 2)); the surfel's rows are binned to the tiles of [c - radius,
  c + radius] on both axes.
* Everything else is 3DGS's (``splat.py``): the centre's cull (|ndc| >
  1.3, w <= 1e-8), the sort depth (view-space z of mu), the SH colour
  seen from the camera towards mu (degree 3, +0.5 clamped at 0), opacity.

Departures:

* The paper centres the low-pass on the projected centre of mu; the
  official code (and this module) on c, the ellipse's centre.
* As ``splat.py``: every row of a tile is blended (no early stop: a tile
  the program stops has every pixel's transmittance at 1e-4 or under),
  and rows no pixel can see add alpha 0.
* The program computes the same expressions in float32 in its own order
  (a fragment's p from k and l as here); the quaternion is used as
  stored, not normalised, as in ``splat.py``.

``render`` counts the fragments the inputs need: for every row that
reaches alpha_min somewhere in its tile, the tile's pixels inside the
row's rect while the pixel's transmittance is still above 1e-4.  A
surfel's rect bounds the pixels where its alpha can reach alpha_min, the
union of the low-pass disk rho2d <= thr and the ellipse rho3d <= thr, thr
= 2 ln(opacity / alpha_min) (``compute_aabb`` with thr in place of 9); it
is the whole tile where rho3d <= thr is no ellipse.

``make_scene`` draws as ``splat.make_scene`` does, in the same order,
with two scales per surfel: exp(normal(log(mean_scale), anisotropy)) per
tangent axis; inert padding has scales 1e-9.

``WORK`` counts what 2DGS needs, whatever implements it:

* blending, per needed fragment: 57 FP32 operations forward (k and l 12,
  the cross product 9, the p3 test, 2 divides, rho3d 3, 2 offsets, rho2d
  4, the min 2, the intersection's depth 5, the near test, the power,
  exp, the opacity product, clamp, 2 threshold tests, select, weight, 6
  for the colour update, 2 for the transmittance) and 134 backward (the
  forward's 48 up to alpha, the unclamped test, 14 for the compositing
  chain as 3DGS counts it, 3 for d power, 2 for the opacity term, the
  min's select, 4 to the centre, 4 to (u, v), 6 to p, 18 through the
  cross product, 15 to Tu, Tv and Tw, 3 for rgb, 15 adds of the pixel
  reduction);
* bytes of the blend: each needed row's 15 attributes (cx, cy, Tu, Tv,
  Tw, rgb, opacity) read once (60 B) and each pixel's colour and
  transmittance written once (16 B); the backward also writes 15 floats
  per row and reads 5 per pixel;
* projection and SH-3 per surfel: 351 FP32 operations forward (mean 18,
  clip 28, divide 3, the rotation's two columns 26, scaled 6, the images
  of the two tangent axes 68, of the centre 4, d 8, t / d 3, the centre
  16, the extents 20, sqrt 4, radius 3, direction 12, basis 30, the 16 x
  3 products and sums 96, offset and clamp 6) and twice that backward;
  ``splat_bytes``, what P1s must move per surfel: 232 B read (xyz 12,
  rot 16, two scales 8, opacity 4, 48 SH 192) and 69 written (centre 8,
  depth 4, T 36, radius 8, colour 12, valid 1).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import splat
from benchmark.reference.splat import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    FRAGMENT_BUDGET,
    LEAVES,
    NDC_CULL,
    SH_C0,
    STOP_T,
    TILE,
    bin_rows,
    rotation,
    sh_rgb,
)

CUTOFF = 3.0
FILTER = math.sqrt(2.0) / 2.0  # the low-pass's sigma
NEAR = 0.2
WORK = {
    "frag_flops": 57, "frag_flops_bwd": 134,
    "row_bytes": 15 * 4, "pixel_bytes": 4 * 4,
    "row_grad_bytes": 15 * 4, "pixel_grad_bytes": 5 * 4,
    "pixels_per_tile": TILE * TILE,
    "splat_flops": 351, "splat_flops_bwd": 2 * 351,
    "splat_bytes": 232 + 69,
}


def make_scene(cfg: dict, seed: int, device) -> dict:
    """{leaf: float32 tensor} of ``cfg['n_splats']`` surfels, padded."""
    n, pad_to = cfg["n_splats"], cfg["pad_to"]
    total = -(-n // pad_to) * pad_to
    k = 3 * (cfg["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, **f32) * (hi - lo) + lo

    def normal(shape, mean, std):
        return torch.randn(shape, generator=gen, **f32) * std + mean

    extent = cfg["extent"]
    xyz = uniform((n, 3), -extent, extent)
    rot = normal((n, 4), 0.0, 1.0)
    rot = rot / rot.norm(dim=1, keepdim=True)
    scale = torch.exp(normal((n, 2), math.log(cfg["mean_scale"]),
                             cfg["anisotropy"]))
    if cfg["opacity_mix"]:
        solid = torch.rand((n, 1), generator=gen, **f32) < 0.55
        a = torch._standard_gamma(torch.full((n, 1), 1.2, **f32),
                                  generator=gen)
        b = torch._standard_gamma(torch.full((n, 1), 3.0, **f32),
                                  generator=gen)
        opacity = torch.where(solid, uniform((n, 1), 0.85, 1.0), a / (a + b))
    else:
        opacity = uniform((n, 1), 0.2, 0.9)
    sh = torch.cat([uniform((n, 3), -0.5, 0.5) / SH_C0,
                    normal((n, k - 3), 0.0, 0.02)], dim=1)

    pad = total - n
    fill = {"xyz": [0.0] * 3, "rot": [1.0, 0.0, 0.0, 0.0],
            "scale": [1e-9] * 2, "opacity": [0.0], "sh": [0.0] * k}
    leaves = dict(zip(LEAVES, (xyz, rot, scale, opacity, sh)))
    return {name: torch.cat([a, torch.tensor(fill[name], **f32).expand(
        pad, -1)]) for name, a in leaves.items()}


def project(leaves, view, proj, cam_pos, width, height, tf32=False):
    """Per-surfel screen attributes (17, N): cx, cy, Tu (3), r, g, b,
    opacity (0 where culled), radius twice (the rows ``bin_rows`` reads as
    cx, cy, rx, ry), Tv (3), Tw (3); with depth (N,) and valid (N,).
    ``tf32`` takes every matrix product in TF32 (the control)."""
    mm, rnd = splat._products(tf32)
    xyz, rot, scale, opacity, sh = (leaves[k] for k in LEAVES)
    n = xyz.shape[0]
    mean_view = mm(xyz, view[:3, :3].T) + view[:3, 3]
    clip = mm(torch.cat([mean_view, xyz.new_ones(n, 1)], dim=1), proj.T)
    w = clip[:, 3]
    w_safe = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[:, :3] / w_safe[:, None]
    in_frustum = (ndc.abs() <= NDC_CULL).all(dim=1) & (w > 1e-8)

    # world (x, y, z, w) -> pixel (x w, y w, w)
    to_pixel = xyz.new_tensor([[width / 2.0, 0.0, 0.0, width / 2.0],
                               [0.0, -height / 2.0, 0.0, height / 2.0],
                               [0.0, 0.0, 0.0, 1.0]])
    m = mm(to_pixel, mm(proj, view))  # (3, 4)
    axes = rotation(rot)[:, :, :2] * scale[:, None, :]  # s_u r1, s_v r2
    hom = torch.cat([mm(m[:, :3], axes),
                     mm(torch.cat([xyz, xyz.new_ones(n, 1)], dim=1),
                        m.T)[:, :, None]], dim=2)  # (N, 3, 3): H
    tu, tv, tw = hom[:, 0], hom[:, 1], hom[:, 2]

    t = xyz.new_tensor([CUTOFF ** 2, CUTOFF ** 2, -1.0])
    d = (t * tw * tw).sum(dim=1)
    ok = d != 0
    f = t / torch.where(ok, d, torch.ones_like(d))[:, None]
    cx = (f * tu * tw).sum(dim=1)
    cy = (f * tv * tw).sum(dim=1)
    ex = torch.sqrt(torch.clamp(cx * cx - (f * tu * tu).sum(dim=1),
                                min=1e-4))
    ey = torch.sqrt(torch.clamp(cy * cy - (f * tv * tv).sum(dim=1),
                                min=1e-4))
    radius = torch.ceil(torch.clamp(torch.maximum(ex, ey),
                                    min=CUTOFF * FILTER))

    dirs = xyz - cam_pos
    dirs = dirs / torch.clamp(dirs.norm(dim=1, keepdim=True), min=1e-12)
    rgb = sh_rgb(sh, dirs, rnd)
    valid = in_frustum & ok & (opacity[:, 0] > 0)
    zero = torch.zeros_like(cx)
    attrs = torch.stack([
        cx, cy, tu[:, 0], tu[:, 1], tu[:, 2],
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
        torch.where(valid, opacity[:, 0], zero), radius, radius,
        tv[:, 0], tv[:, 1], tv[:, 2], tw[:, 0], tw[:, 1], tw[:, 2],
    ])
    return attrs, -mean_view[:, 2], valid


def render(leaves, view, proj, cam_pos, width, height, grad=False,
           tf32=False):
    """Render one frame and its loss sum(image**2); with ``grad`` also the
    loss's gradient into each leaf's ``.grad``.

    leaves: {name: (N, .) float32} on one device (requires_grad with
    ``grad``).  view, proj (4, 4), cam_pos (3,): float32 on that device.
    Returns (image (H, W, 3), the loss as a float64 () tensor, stats
    {"rows", "fragments", "tiles"} of what the inputs need)."""
    dev = leaves["xyz"].device
    with torch.set_grad_enabled(grad):
        attrs, depth, valid = project(leaves, view, proj, cam_pos, width,
                                      height, tf32)
    table = attrs.detach()
    sid_sorted, starts, tiles_x, tiles_y = bin_rows(table, depth.detach(),
                                                    valid, width, height)
    counts = starts[1:] - starts[:-1]
    g_table = torch.zeros_like(table) if grad else None
    image = torch.zeros((tiles_y * TILE, tiles_x * TILE, 3), device=dev)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    local = torch.arange(TILE * TILE, device=dev)
    rows_needed = torch.zeros((), dtype=torch.int64, device=dev)
    frags_needed = torch.zeros((), dtype=torch.int64, device=dev)

    order = torch.argsort(counts, descending=True)
    order = order[counts[order] > 0]
    ordered_counts = counts[order].tolist()
    g0 = 0
    while g0 < len(order):
        widest = ordered_counts[g0]
        g1 = min(len(order),
                 g0 + max(1, FRAGMENT_BUDGET // (widest * TILE * TILE)))
        tiles = order[g0:g1]
        r = torch.arange(widest, device=dev)
        live = r[None, :] < counts[tiles][:, None]
        first = starts[tiles][:, None]
        idx = torch.where(live, first + r, first)
        sid = sid_sorted[idx]
        rows = table[:, sid]
        if grad:
            rows.requires_grad_(True)
        pix_x = (tiles % tiles_x)[:, None] * TILE + local % TILE
        pix_y = (tiles // tiles_x)[:, None] * TILE + local // TILE
        with torch.set_grad_enabled(grad):
            rgb, trans, in_rect, keep = _blend(
                rows, live, pix_x.float() + 0.5, pix_y.float() + 0.5)
            inside = (pix_y < height) & (pix_x < width)
            part = ((rgb * rgb).sum(-1) * inside).sum()
        if grad:
            (g_rows,) = torch.autograd.grad(part, rows)
            g_table.index_add_(1, sid[live], g_rows[:, live])
        loss += part.detach().double()
        with torch.no_grad():
            needed = in_rect & keep.any(dim=2, keepdim=True) \
                & (trans > STOP_T)
            frags_needed += needed.sum()
            rows_needed += needed.any(dim=2).sum()
            image[pix_y, pix_x] = rgb.detach()
        g0 = g1
    if grad:
        torch.autograd.backward(attrs, g_table)
    stats = {"rows": int(rows_needed), "fragments": int(frags_needed),
             "tiles": tiles_x * tiles_y}
    return image[:height, :width], loss, stats


def _blend(rows, live, px, py):
    """Front-to-back composite of a group of tiles: rows (17, G, R), live
    (G, R), pixel centres px / py (G, P).  Returns (rgb (G, P, 3), the
    transmittance in front of each fragment (G, R, P), in_rect and keep
    (G, R, P))."""
    (cx, cy, tu0, tu1, tu2, r, g, b, op, _, _, tv0, tv1, tv2, tw0, tw1,
     tw2) = (a[:, :, None] for a in rows)
    x = px[:, None, :]
    y = py[:, None, :]
    k0, k1, k2 = x * tw0 - tu0, x * tw1 - tu1, x * tw2 - tu2
    l0, l1, l2 = y * tw0 - tv0, y * tw1 - tv1, y * tw2 - tv2
    p1 = k1 * l2 - k2 * l1
    p2 = k2 * l0 - k0 * l2
    p3 = k0 * l1 - k1 * l0
    hit = p3 != 0
    p3 = torch.where(hit, p3, torch.ones_like(p3))
    u = p1 / p3
    v = p2 / p3
    rho3d = u * u + v * v
    rho2d = 2.0 * ((x - cx) ** 2 + (y - cy) ** 2)
    on_disk = rho3d <= rho2d
    rho = torch.where(on_disk, rho3d, rho2d)
    depth = torch.where(on_disk, u * tw0 + v * tw1 + tw2, tw2)
    alpha = torch.minimum(op * torch.exp(-0.5 * rho),
                          torch.full_like(rho, ALPHA_CLAMP))
    keep = live[:, :, None] & hit & (depth >= NEAR) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    through = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(through[:, :1]), through[:, :-1]], 1)
    weight = alpha * trans
    rgb = torch.stack([(weight * c).sum(dim=1) for c in (r, g, b)], dim=-1)
    with torch.no_grad():
        in_rect = _in_rect(rows.detach(), x, y) & live[:, :, None]
    return rgb, trans, in_rect, keep


def _in_rect(rows, x, y):
    """(G, R, P): whether each pixel centre lies in its row's rect, the
    bounding box of the pixels where the row's alpha can reach alpha_min
    (module docstring)."""
    (cx, cy, tu0, tu1, tu2, _, _, _, op, _, _, tv0, tv1, tv2, tw0, tw1,
     tw2) = (a[:, :, None] for a in rows)
    thr = 2.0 * (torch.log(torch.clamp(op, min=1e-30))
                 - math.log(ALPHA_MIN))
    d = thr * (tw0 * tw0 + tw1 * tw1) - tw2 * tw2
    ellipse = d < 0
    d = torch.where(ellipse, d, -torch.ones_like(d))

    def tdot(p0, p1, p2, q0, q1, q2):  # sum_k t_k p_k q_k / d
        return (thr * (p0 * q0 + p1 * q1) - p2 * q2) / d

    mx = tdot(tu0, tu1, tu2, tw0, tw1, tw2)
    my = tdot(tv0, tv1, tv2, tw0, tw1, tw2)
    ex = torch.sqrt(torch.clamp(mx * mx - tdot(tu0, tu1, tu2, tu0, tu1, tu2),
                                min=0.0))
    ey = torch.sqrt(torch.clamp(my * my - tdot(tv0, tv1, tv2, tv0, tv1, tv2),
                                min=0.0))
    r2 = torch.sqrt(torch.clamp(0.5 * thr, min=0.0))
    inside = (x >= torch.minimum(mx - ex, cx - r2)) \
        & (x <= torch.maximum(mx + ex, cx + r2)) \
        & (y >= torch.minimum(my - ey, cy - r2)) \
        & (y <= torch.maximum(my + ey, cy + r2))
    return (thr >= 0) & (inside | ~ellipse)


def train_steps(scene, poses, mix, width, height, tf32=False):
    """The reference's training steps from ``scene`` (leaves, not
    modified): one per pose (view, proj, cam_pos), loss sum(image**2),
    SGD with the mix's learning rates, momentum and dampening, through
    this module's autograd.  Returns (losses [float], first gradient
    {leaf: tensor}, final leaves {leaf: tensor}, first image, stats of
    each step)."""
    params = {k: scene[k].detach().clone().requires_grad_(True)
              for k in LEAVES}
    opt = splat.SGD(params, mix["lr"], mix["momentum"], mix["dampening"])
    losses, stats, first_grad, first_image = [], [], None, None
    for view, proj, cam_pos in poses:
        for p in params.values():
            p.grad = None
        image, loss, st = render(params, view, proj, cam_pos, width, height,
                                 grad=True, tf32=tf32)
        losses.append(float(loss))
        stats.append(st)
        if first_grad is None:
            first_grad = {k: p.grad.clone() for k, p in params.items()}
            first_image = image
        opt.step()
    return losses, first_grad, {k: p.detach() for k, p in params.items()}, \
        first_image, stats
