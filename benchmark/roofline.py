"""Peaks of the card and the work a frame or a training step needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet), FP32 outside the tensor
cores and HBM3, at the full 700 W power limit; a card set below it runs
slower, so the run records the card's limit beside every share.

Work, counted from what the inputs need, whatever implements it: the
reference's count of needed rows, fragments and tiles (``needed``) times
the counts per unit that the configuration's reference module gives in
its ``WORK`` (``cells.py``): FP32 operations per fragment (``frag_flops``,
``frag_flops_bwd``) and per splat (``splat_flops``, ``splat_flops_bwd``),
bytes per row and per pixel (``row_bytes``, ``pixel_bytes``,
``row_grad_bytes``, ``pixel_grad_bytes``) and pixels per tile.

A share of the roofline takes the larger of operations over the FP32 peak
and bytes over the HBM peak as the least time the card could take.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def blend_bound_s(needed: dict, train: bool, work: dict) -> float:
    """Least seconds the card could spend blending one frame (with
    ``train`` also its backward), from the needed rows and fragments."""
    pixels = needed["tiles"] * work["pixels_per_tile"]
    fwd = max(needed["fragments"] * work["frag_flops"] / PEAK_FP32_FLOPS,
              (needed["rows"] * work["row_bytes"]
               + pixels * work["pixel_bytes"]) / PEAK_HBM_BYTES)
    if not train:
        return fwd
    bwd = max(needed["fragments"] * work["frag_flops_bwd"] / PEAK_FP32_FLOPS,
              (needed["rows"] * (work["row_bytes"] + work["row_grad_bytes"])
               + pixels * work["pixel_grad_bytes"]) / PEAK_HBM_BYTES)
    return fwd + bwd


def step_flops(n_splats: int, needed: dict, train: bool,
               work: dict) -> float:
    """FP32 operations one frame (or, with ``train``, one training step)
    needs: projection of every splat, and the needed fragments."""
    per_splat = work["splat_flops"] + (work["splat_flops_bwd"] if train
                                       else 0)
    per_frag = work["frag_flops"] + (work["frag_flops_bwd"] if train else 0)
    return n_splats * per_splat + needed["fragments"] * per_frag


def mfu(run) -> float | None:
    """Share of the FP32 peak (%) that ``step_flops`` take of the traced
    window's time per step or frame."""
    if not run.events or not run.needed or not run.steps:
        return None
    flops = step_flops(run.n_splats, run.needed, run.kind == "train",
                       run.work)
    return 100.0 * flops * run.steps / (PEAK_FP32_FLOPS * run.window_s)
