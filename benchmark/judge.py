"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to its limit (``limits/<cell>.json``).

Training (the first three steps of the object the window then drives):
  loss_gap          worst step's |loss - reference| / |reference|
  grad_gap_median   the median over the leaves of | |g| - |g_ref| | over
                    max(|g_ref| of the leaf, of the median leaf), g the
                    first gradient as the optimizer's momentum buffer
                    holds it after one step
  change_gap_median the same of each leaf's change over the three steps;
                    leaves whose reference gradient is under a thousandth
                    of the median leaf's are left out (they move by
                    round-off alone)
  img_rms           the first step's image: rms(image - reference) over
                    rms(reference)
The worst leaf's gap swings from seed to seed with the rounding of one
ill-conditioned splat's projection, which one leaf's norm can be made of
(PERF.md, section 2); the median leaf's is steady.
Viewing (frames sampled from the seed among those the window rendered):
  img_rms         the worst sampled frame's
"""

from __future__ import annotations

import torch


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _median(values):
    return sorted(values)[(len(values) - 1) // 2]


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Per leaf, the gap of the norms over max(the leaf's, the median
    leaf's reference norm)."""
    ref_n = {k: _norm(ref[k]) for k in leaves}
    floor = _median(list(ref_n.values()))
    return {k: abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], floor, 1e-30)
            for k in leaves}


def img_rms(image, ref) -> float:
    diff = _norm(image.float() - ref.float())
    return diff / max(_norm(ref), 1e-30)


def moving_leaves(grad_ref: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: _norm(g) for k, g in grad_ref.items()}
    median = _median(list(norms.values()))
    return [k for k, v in norms.items() if v >= 1e-3 * median]


def train_checks(prog: dict, ref: dict, leaves) -> tuple[dict, dict]:
    """(the compared numbers, each leaf's gradient and change gaps) of
    prog / ref: {"losses", "grad", "change", "image"}."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = leaf_gaps(prog["change"], ref["change"],
                       moving_leaves(ref["grad"]))
    return {
        "loss_gap": max(losses),
        "grad_gap_median": _median(list(grad.values())),
        "change_gap_median": _median(list(change.values())),
        "img_rms": img_rms(prog["image"], ref["image"]),
    }, {"grad": grad, "change": change}


def verdict(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok and len(table) > 0, table
