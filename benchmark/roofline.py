"""Peaks of the card and the work a frame or a training step needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet), FP32 outside the tensor
cores and HBM3, at the full 700 W power limit; a card set below it runs
slower, so the run records the card's limit beside every share.

Work, counted from what the inputs need, whatever implements it:

* blending: per needed fragment (``reference.splat.render``'s count) 30
  FP32 operations forward (2 offsets, 9 for the power, 4 for the rect
  test, exp, the opacity product, clamp, 2 threshold tests, select,
  weight, 6 for the colour update, 2 for the transmittance) and 73
  backward (the forward's 21 up to alpha plus the unclamped test, 2 for
  the transmittance, the weight, 5 for g.c, the suffix add, 2 for
  max(1 - alpha, .), the divide, the subtraction, the alpha select, 3 for
  d power, 2 for the opacity term, 17 for the mean and conic terms, 3 for
  rgb, 9 adds of the pixel reduction);
* bytes of the blend: each needed row's 11 attributes read once (44 B)
  and each pixel's colour and transmittance written once (16 B); the
  backward also writes 10 floats per row and reads 5 per pixel;
* projection and SH-3 per splat: ``PROJECT_FLOPS`` forward (mean 18, clip
  28, divide 3, rotation 30, scales 3, 3D covariance 48, the fov clamp 4,
  Jacobian 6, J W 18, 2D covariance 72, conic 7, extents 4, pixel centre
  4, direction 12, basis 30, the 16 x 3 products and sums 96, offset and
  clamp 6) and twice that backward.

A share of the roofline takes the larger of operations over the FP32 peak
and bytes over the HBM peak as the least time the card could take.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FLOPS_FWD = 30
FLOPS_BWD = 73
ROW_BYTES = 11 * 4
PIXEL_BYTES = 4 * 4
ROW_GRAD_BYTES = 10 * 4
PIXEL_GRAD_BYTES = 5 * 4
PIXELS_PER_TILE = 256
PROJECT_FLOPS = 390


def blend_bound_s(needed: dict, train: bool) -> float:
    """Least seconds the card could spend blending one frame (with
    ``train`` also its backward), from the needed rows and fragments."""
    pixels = needed["tiles"] * PIXELS_PER_TILE
    fwd = max(needed["fragments"] * FLOPS_FWD / PEAK_FP32_FLOPS,
              (needed["rows"] * ROW_BYTES + pixels * PIXEL_BYTES)
              / PEAK_HBM_BYTES)
    if not train:
        return fwd
    bwd = max(needed["fragments"] * FLOPS_BWD / PEAK_FP32_FLOPS,
              (needed["rows"] * (ROW_BYTES + ROW_GRAD_BYTES)
               + pixels * PIXEL_GRAD_BYTES) / PEAK_HBM_BYTES)
    return fwd + bwd


def step_flops(n_splats: int, needed: dict, train: bool) -> float:
    """FP32 operations one frame (or, with ``train``, one training step)
    needs: projection and SH of every splat, and the needed fragments."""
    per_splat = PROJECT_FLOPS * (3 if train else 1)
    per_frag = FLOPS_FWD + (FLOPS_BWD if train else 0)
    return n_splats * per_splat + needed["fragments"] * per_frag


def mfu(run) -> float | None:
    """Share of the FP32 peak (%) that ``step_flops`` take of the traced
    window's time per step or frame."""
    if not run.events or not run.needed or not run.steps:
        return None
    flops = step_flops(run.n_splats, run.needed, run.kind == "train")
    return 100.0 * flops * run.steps / (PEAK_FP32_FLOPS * run.window_s)
