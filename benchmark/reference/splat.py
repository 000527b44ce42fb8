"""Plain PyTorch reference of 3D Gaussian splatting, the primitive that a
configuration names with ``"reference": "splat"``: the scene, the render,
its loss gradient and the optimizer step that the benchmark holds the
program's timed path to, and the work they need (``cells.py`` gives the
contract of such a module).

It imports nothing of the program and takes nothing the program made: it
works the projection, the spherical harmonics, the tile binning and the
blend out again from the scene's leaves and the camera.  The semantics are
those of 3D Gaussian Splatting (Kerbl et al., SIGGRAPH 2023) as the
program defines them (its ``RenderConfig`` defaults):

* EWA projection with the view ray clamped to 1.3x the fov tangents, the
  +0.3 px low-pass, the |ndc| > 1.3 cull, 3-sigma half-extents per axis,
  the conic in the y-down image frame, the quaternion used as stored (not
  normalised), SH degree 3 with the +0.5 offset clamped at 0;
* 16x16 tiles; in each tile the rows ordered by (the top bits of the
  float32 depth pattern, splat index), the depth field as wide as 32 bits
  less the bits of (tiles + 1);
* a fragment counts where it lies in the row's 3-sigma rect, its power is
  at most 0 and alpha = min(opacity * exp(power), 0.99) is at least 1/255;
  front-to-back compositing over every row, background 0.

It departs from the program in two ways that change no image beyond
rounding: it keeps rows no pixel of the tile can see (they add alpha 0),
and it has no early stop (a tile the program stops has every pixel's
transmittance at 1e-4 or under, so the rows it skips add at most that
much).  Tiles go in groups of at most ``FRAGMENT_BUDGET`` fragments, each
group's graph freed before the next, so the garden scene fits.

``render`` also counts the fragments the inputs need: those in a row's
rect, of rows that reach alpha_min somewhere in the tile, while the
pixel's transmittance is still above 1e-4 (3DGS's per-pixel stop).  The
benchmark's roofline arithmetic reads that count with ``WORK``.

``make_scene`` draws the scene the benchmark hands to both sides, on the
run's device from the seed.  The distributions are those of the program's
synthetic scene generator (``models/random_scene.py``), drawn with one
``torch.Generator`` in a few large calls, so set-up moves no scene over the
host link:

  xyz      uniform in [-extent, extent]^3
  rot      normal (w, x, y, z), normalised
  scale    exp(normal(log(mean_scale), anisotropy)) per axis
  opacity  uniform [0.2, 0.9], or with ``opacity_mix`` 55% uniform
           [0.85, 1.0] and the rest Beta(1.2, 3.0)
  sh       DC uniform [-0.5, 0.5] / C0, the other 45 coefficients
           normal(0, 0.02)

then padded to a multiple of ``pad_to`` with inert splats (opacity 0 at the
origin, unit quaternion, scale 1e-9, SH 0), as the program pads.  The same
seed gives the same scene on the same device.

``WORK`` counts what 3DGS needs, whatever implements it:

* blending: per needed fragment 30 FP32 operations forward (2 offsets, 9
  for the power, 4 for the rect test, exp, the opacity product, clamp, 2
  threshold tests, select, weight, 6 for the colour update, 2 for the
  transmittance) and 73 backward (the forward's 21 up to alpha plus the
  unclamped test, 2 for the transmittance, the weight, 5 for g.c, the
  suffix add, 2 for max(1 - alpha, .), the divide, the subtraction, the
  alpha select, 3 for d power, 2 for the opacity term, 17 for the mean and
  conic terms, 3 for rgb, 9 adds of the pixel reduction);
* bytes of the blend: each needed row's 11 attributes read once (44 B)
  and each pixel's colour and transmittance written once (16 B); the
  backward also writes 10 floats per row and reads 5 per pixel; a tile
  holds ``TILE`` squared pixels;
* projection and SH-3 per splat: 390 FP32 operations forward (mean 18,
  clip 28, divide 3, rotation 30, scales 3, 3D covariance 48, the fov
  clamp 4, Jacobian 6, J W 18, 2D covariance 72, conic 7, extents 4, pixel
  centre 4, direction 12, basis 30, the 16 x 3 products and sums 96,
  offset and clamp 6) and twice that backward.
"""

from __future__ import annotations

import math

import torch

TILE = 16
NDC_CULL = 1.3
FOV_CLAMP = 1.3
LOW_PASS = 0.3
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
STOP_T = 1e-4
FRAGMENT_BUDGET = 1 << 24  # fragments of one tile group
LEAVES = ("xyz", "rot", "scale", "opacity", "sh")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
WORK = {
    "frag_flops": 30, "frag_flops_bwd": 73,
    "row_bytes": 11 * 4, "pixel_bytes": 4 * 4,
    "row_grad_bytes": 10 * 4, "pixel_grad_bytes": 5 * 4,
    "pixels_per_tile": TILE * TILE,
    "splat_flops": 390, "splat_flops_bwd": 2 * 390,
}


def make_scene(cfg: dict, seed: int, device) -> dict:
    """{leaf: float32 tensor} of ``cfg['n_splats']`` splats, padded."""
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
    scale = torch.exp(normal((n, 3), math.log(cfg["mean_scale"]),
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
            "scale": [1e-9] * 3, "opacity": [0.0], "sh": [0.0] * k}
    leaves = dict(zip(LEAVES, (xyz, rot, scale, opacity, sh)))
    return {name: torch.cat([a, torch.tensor(fill[name], **f32).expand(
        pad, -1)]) for name, a in leaves.items()}


class _RoundTF32(torch.autograd.Function):
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as a TF32 matrix product rounds its inputs; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
        return bits.view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def _products(tf32: bool):
    """(matrix product, operand rounding): float32, or with ``tf32`` each
    operand rounded to TF32 first (the control's precision)."""
    if not tf32:
        return torch.matmul, lambda x: x
    rnd = _RoundTF32.apply
    return (lambda a, b: rnd(a) @ rnd(b)), rnd


def sh_rgb(sh, dirs, rnd=lambda x: x):
    """RGB of degree-3 SH (N, 48), coefficients interleaved per colour,
    seen along unit directions (N, 3); ``rnd`` rounds the operands of the
    contraction."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    basis = torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z,
        SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ], dim=-1)
    coeffs = rnd(sh.reshape(sh.shape[0], 16, 3))
    rgb = (rnd(basis)[:, :, None] * coeffs).sum(dim=1) + 0.5
    return torch.maximum(rgb, torch.zeros_like(rgb))


def rotation(q):
    """(N, 3, 3) rotation matrices of (w, x, y, z) quaternions as stored."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def project(leaves, view, proj, cam_pos, width, height, tf32=False):
    """Per-splat screen attributes (11, N): cx, cy, conic A, B, C, r, g, b,
    opacity (0 where culled), rx, ry; with depth (N,) and valid (N,).
    ``tf32`` takes every matrix product in TF32 (the control)."""
    mm, rnd = _products(tf32)
    xyz, rot, scale, opacity, sh = (leaves[k] for k in LEAVES)
    n = xyz.shape[0]
    mean_view = mm(xyz, view[:3, :3].T) + view[:3, 3]
    clip = mm(torch.cat([mean_view, xyz.new_ones(n, 1)], dim=1), proj.T)
    w = clip[:, 3]
    w_safe = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    ndc = clip[:, :3] / w_safe[:, None]
    in_frustum = (ndc.abs() <= NDC_CULL).all(dim=1) & (w > 1e-8)

    rmat = rotation(rot)
    cov3 = mm(mm(rmat, torch.diag_embed(scale * scale)), rmat.transpose(1, 2))
    tan_x, tan_y = 1.0 / proj[0, 0], 1.0 / proj[1, 1]
    focal = height / (2.0 * tan_y)
    tz = mean_view[:, 2]
    tz = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    tx = torch.minimum(torch.maximum(mean_view[:, 0] / tz, -FOV_CLAMP * tan_x),
                       FOV_CLAMP * tan_x) * tz
    ty = torch.minimum(torch.maximum(mean_view[:, 1] / tz, -FOV_CLAMP * tan_y),
                       FOV_CLAMP * tan_y) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([focal / tz, zero, -focal * tx / (tz * tz),
                       zero, focal / tz, -focal * ty / (tz * tz)],
                      dim=1).reshape(n, 2, 3)
    t = mm(jac, view[:3, :3])
    cov2 = mm(mm(t, cov3), t.transpose(1, 2))
    cxx = cov2[:, 0, 0] + LOW_PASS
    cyy = cov2[:, 1, 1] + LOW_PASS
    cxy = cov2[:, 0, 1]
    det = cxx * cyy - cxy * cxy
    ok = det > 0
    det = torch.where(ok, det, torch.ones_like(det))

    cx = (ndc[:, 0] + 1.0) * 0.5 * width
    cy = (1.0 - ndc[:, 1]) * 0.5 * height
    dirs = xyz - cam_pos
    dirs = dirs / torch.clamp(dirs.norm(dim=1, keepdim=True), min=1e-12)
    rgb = sh_rgb(sh, dirs, rnd)
    valid = in_frustum & ok & (opacity[:, 0] > 0)
    attrs = torch.stack([
        cx, cy, cyy / det, cxy / det, cxx / det,
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
        torch.where(valid, opacity[:, 0], zero),
        3.0 * torch.sqrt(torch.clamp(cxx, min=0)),
        3.0 * torch.sqrt(torch.clamp(cyy, min=0)),
    ])
    return attrs, -mean_view[:, 2], valid


def bin_rows(attrs, depth, valid, width, height):
    """Every (splat, tile) pair of each valid splat's tile bbox, sorted by
    (tile, depth field, splat).  Returns (splat of each row, tile starts
    (tiles + 1,), tiles_x, tiles_y)."""
    dev = attrs.device
    n = attrs.shape[1]
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    cx, cy, rx, ry = attrs[0], attrs[1], attrs[9], attrs[10]
    big = float(2 ** 30)

    def tile_of(v):
        return torch.clamp(torch.floor(v / TILE), -big, big).to(torch.int64)

    x0, x1 = tile_of(cx - rx), tile_of(cx + rx)
    y0, y1 = tile_of(cy - ry), tile_of(cy + ry)
    seen = valid & (x1 >= 0) & (x0 < tiles_x) & (y1 >= 0) & (y0 < tiles_y)
    x0, x1 = x0.clamp(0, tiles_x - 1), x1.clamp(0, tiles_x - 1)
    y0, y1 = y0.clamp(0, tiles_y - 1), y1.clamp(0, tiles_y - 1)
    wide = x1 - x0 + 1
    count = torch.where(seen, wide * (y1 - y0 + 1), torch.zeros_like(wide))
    sid = torch.repeat_interleave(torch.arange(n, device=dev), count)
    k = torch.arange(sid.shape[0], device=dev) - (count.cumsum(0) - count)[sid]
    tile = (y0[sid] + k // wide[sid]) * tiles_x + x0[sid] + k % wide[sid]

    num_tiles = tiles_x * tiles_y
    depth_bits = 32 - (num_tiles + 1).bit_length()
    id_bits = max((n - 1).bit_length(), 1)
    pattern = torch.clamp(depth, min=0.0).view(torch.int32).to(torch.int64)
    field = (pattern & 0xFFFFFFFF) >> (32 - depth_bits)
    key = (((tile << depth_bits) | field[sid]) << id_bits) | sid
    key, _ = torch.sort(key)
    starts = torch.searchsorted(
        key, torch.arange(num_tiles + 1, device=dev) << (depth_bits + id_bits))
    return key & ((1 << id_bits) - 1), starts, tiles_x, tiles_y


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
            needed = in_rect & keep.any(dim=2, keepdim=True) & (trans > STOP_T)
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
    """Front-to-back composite of a group of tiles: rows (11, G, R), live
    (G, R), pixel centres px / py (G, P).  Returns (rgb (G, P, 3), the
    transmittance in front of each fragment (G, R, P), in_rect and keep
    (G, R, P))."""
    cx, cy, ca, cb, cc, r, g, b, op, rx, ry = (a[:, :, None] for a in rows)
    dx = px[:, None, :] - cx
    dy = py[:, None, :] - cy
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    in_rect = (dx.abs() <= rx) & (dy.abs() <= ry) & live[:, :, None]
    alpha = torch.minimum(op * torch.exp(power),
                          torch.full_like(power, ALPHA_CLAMP))
    keep = in_rect & (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    through = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(through[:, :1]), through[:, :-1]], 1)
    weight = alpha * trans
    rgb = torch.stack([(weight * c).sum(dim=1) for c in (r, g, b)], dim=-1)
    return rgb, trans, in_rect, keep


class SGD:
    """torch.optim.SGD's update with momentum and dampening, written out:
    the buffer is the first gradient at step 1, then b = mu b + (1 - d) g;
    p -= lr b."""

    def __init__(self, params: dict, lrs: dict, momentum: float,
                 dampening: float):
        self.params, self.lrs = params, lrs
        self.momentum, self.dampening = momentum, dampening
        self.buf = {}

    @torch.no_grad()
    def step(self):
        for k, p in self.params.items():
            if k in self.buf:
                self.buf[k].mul_(self.momentum).add_(
                    p.grad, alpha=1 - self.dampening)
            else:
                self.buf[k] = p.grad.clone()
            p.sub_(self.lrs[k] * self.buf[k])


def train_steps(scene, poses, mix, width, height, tf32=False):
    """The reference's training steps from ``scene`` (leaves, not
    modified): one per pose (view, proj, cam_pos), loss sum(image**2),
    SGD with the mix's learning rates, momentum and dampening.  Returns
    (losses [float], first gradient {leaf: tensor}, final leaves {leaf:
    tensor}, first image, stats of each step)."""
    params = {k: scene[k].detach().clone().requires_grad_(True)
              for k in LEAVES}
    opt = SGD(params, mix["lr"], mix["momentum"], mix["dampening"])
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

