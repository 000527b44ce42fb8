"""Oracle rasterizer: globally sorted, per-pixel alpha blending over the
whole image (the port of the JAX package's ``ops/raster_jnp.py``).

Ground truth for the CPU tests only: O(N * H * W).  Splats are sorted
nearest-first and composited front to back,
out = sum_i c_i a_i T_i + bg * T_final, T_i = prod_{j<i} (1 - a_j).
"""

from __future__ import annotations

import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.ops.projection import ProjectedSplats


def fragment_exp(power: torch.Tensor) -> torch.Tensor:
    """exp of f32 fragment powers, reproducible bit for bit.

    On the CPU ``torch.exp`` rounds differently in its vectorized body
    (Sleef) and its scalar tail (libm) by up to 1 ulp, and the thread
    partition decides which elements fall in the tail, so which fragments
    cross the alpha_min / ball thresholds would depend on the thread count.
    exp in f64 rounded to f32 is the correctly rounded value on any
    partition.  On CUDA ``torch.exp`` is the same ``expf`` the blend kernel
    calls, which the kernel-vs-plain comparison relies on."""
    if power.device.type == "cpu":
        return torch.exp(power.double()).float()
    return torch.exp(power)


def splat_alpha_color(dx, dy, conic, opacity, color, radius,
                      cfg: RenderConfig):
    """Fragment semantics for broadcastable (splat, pixel) pairs; every
    discard is folded in as alpha=0.  Returns (alpha, color)."""
    A, B, C = conic[..., 0], conic[..., 1], conic[..., 2]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    in_rect = (torch.abs(dx) <= radius[..., 0]) & (
        torch.abs(dy) <= radius[..., 1])
    mode = int(cfg.mode)
    if mode == RenderMode.BILLBOARD:
        return in_rect.to(power.dtype), color
    gauss = fragment_exp(power)
    raw = opacity * gauss
    # minimum (not clamp): jnp.minimum's half gradient at a tie
    alpha = torch.minimum(raw, torch.full_like(raw, cfg.alpha_clamp))
    keep = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    if mode in (RenderMode.FLAT_BALL, RenderMode.GAUSSIAN_BALL):
        alpha = (keep & (alpha > cfg.ball_threshold)).to(alpha.dtype)
        if mode == RenderMode.GAUSSIAN_BALL:
            color = color * gauss[..., None]
    return alpha, color


def surfel_alpha_color(rows, px, py, color, cfg: RenderConfig):
    """``splat_alpha_color`` of a chunk of surfels: rows (15, c) their
    table attributes cx .. Tw2, px / py (H, W) the pixel centres, color
    (c, 3).  Returns alpha (c, H, W) and color (c, 1, 1, 3)."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels.tile_raster_fwd import (
        surfel_fragments,
    )

    h, w = px.shape
    live = torch.ones((1, rows.shape[1]), dtype=torch.bool,
                      device=rows.device)
    _, _, _, alpha, _ = surfel_fragments(rows[:, None, :], live,
                                         px.reshape(1, -1),
                                         py.reshape(1, -1), cfg)
    return alpha.reshape(-1, h, w), color[:, None, None, :]


def rasterize_oracle(splats: ProjectedSplats, cfg: RenderConfig,
                     chunk: int = 8, return_aux: bool = False):
    """Blend all splats over the full image, no tiling (surfels with the
    blend's ray-disk fragments, ``surfel_alpha_color``)."""
    H, W = cfg.height, cfg.width
    dev = splats.depth.device
    depth_key = torch.where(splats.valid, splats.depth,
                            torch.full_like(splats.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    opacity = torch.where(splats.valid, splats.opacity,
                          torch.zeros_like(splats.opacity))
    mean2d, conic, color, radius, opacity = (
        None if a is None else a[order]
        for a in (splats.mean2d, splats.conic, splats.color, splats.radius,
                  opacity)
    )
    px = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    if splats.surfel:
        from gaussiansplattingviewer_tpu_torch.ops import binning

        rows = binning.pack_table(splats)[order].T[:binning.SURFEL_ATTRS]
        grid_y, grid_x = torch.meshgrid(py, px, indexing="ij")
    rgb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    for s in range(0, order.shape[0], chunk):
        if splats.surfel:
            a, c = surfel_alpha_color(rows[:, s:s + chunk], grid_x,
                                      grid_y, color[s:s + chunk], cfg)
        else:
            m = mean2d[s:s + chunk]
            dx = px[None, None, :] - m[:, 0, None, None]  # (c, 1, W)
            dy = py[None, :, None] - m[:, 1, None, None]  # (c, H, 1)
            a, c = splat_alpha_color(
                dx, dy,
                conic[s:s + chunk, None, None, :],
                opacity[s:s + chunk, None, None],
                color[s:s + chunk, None, None, :],
                radius[s:s + chunk, None, None, :],
                cfg,
            )
        one_m = 1.0 - a
        shifted = torch.cat([torch.ones_like(one_m[:1]), one_m[:-1]], dim=0)
        prefix = torch.cumprod(shifted, dim=0)
        w_i = a * prefix
        rgb = rgb + T[..., None] * torch.sum(w_i[..., None] * c, dim=0)
        T = T * torch.prod(one_m, dim=0)
    out = rgb + cfg.background * T[..., None]
    if return_aux:
        aux = {"transmittance": T}
        if cfg.debug:
            from gaussiansplattingviewer_tpu_torch.ops.raster_tiles import (
                debug_counters,
            )

            aux.update(debug_counters(splats, out))
        return out, aux
    return out
