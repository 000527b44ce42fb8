"""Per-scene autotuner (the port of the JAX ``ops/autotune.py``).

It measures the scene on representative camera poses and returns a
RenderConfig:

  * ``tuned_config`` sizes the duplicate-slot pools (``dense_small_slots``,
    ``pool_ladder``, ``pool_huge_entries``) and the table budget
    (``table_budget_rows``) from the per-splat tile-footprint histogram;
  * ``autotune(..., probe=True)`` re-tightens the table budget to the
    probed live duplicate count;
  * ``tune_fused`` decides whether to take the fused prefix/residual path
    (ops/fused.py) and sizes its budgets from one full-table train forward
    per probe pose.

The port bins with an exact pipeline, so of these fields only
``table_budget_rows`` and the fused-path fields change what it computes.
The pool fields are written anyway, because ``_capacity_of`` reads them:
with them, ``tune_fused(fused=None)`` takes the JAX package's decision for
the same scene and config.  The decision rule is the JAX one, a TPU cost
model (slot capacity against processed rows); whether the H100 wants
another is an open question (PERF.md).

Everything is numpy on the host apart from the probes (projection, the
binning and the probe forward), which run on the scene's device.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.fused import probe_forward
from gaussiansplattingviewer_tpu_torch.ops.projection import project


def tile_counts(scene, view, proj, cam_pos, cfg: RenderConfig):
    """Per-splat clamped tile-bbox footprint (0 for culled splats)."""
    with torch.no_grad():
        splats = project(scene, view, proj, cam_pos, cfg)
        _, _, _, _, count, _ = binning.tile_bbox(splats, cfg)
    return count


def measure_counts(scene, views, projs, cam_positions, cfg: RenderConfig):
    """Elementwise-max footprint over representative poses -> np (N,)
    i32."""
    counts = None
    for v, p, c in zip(views, projs, cam_positions):
        cnt = tile_counts(scene, v, p, c, cfg).cpu().numpy()
        counts = cnt if counts is None else np.maximum(counts, cnt)
    return counts


def _round_up(x: int, q: int) -> int:
    return -(-int(x) // q) * q


def _ladder_capacity(counts_live, n, k1, span_cap, safety, round_to,
                     ratio: float = 2.0, max_tiers: int = 20):
    """The geometric ladder for a given k1 -> (capacity, ladder, huge
    entries).  Tier coverages grow by ``ratio``."""
    covs = []
    c = k1
    while True:
        c = max(int(np.ceil(c * ratio)), c + 1)
        if c >= span_cap or len(covs) >= max_tiers:
            break
        covs.append(c)
    ladder = []
    lo = k1
    for cov in covs:
        pop = int(np.count_nonzero((counts_live > lo) & (counts_live <= cov)))
        lo = cov
        if pop == 0:
            continue
        entries = _round_up(pop * safety, 8)
        ladder.append((cov - k1, entries))
    huge_pop = int(np.count_nonzero(counts_live > lo))
    huge_entries = max(_round_up(huge_pop * safety, 8), 8)
    capacity = (
        k1 * n
        + sum(kx * c for kx, c in ladder)
        + span_cap * huge_entries
    )
    # tiers hungriest-first (strictly decreasing extras)
    return capacity, tuple(reversed(ladder)), huge_entries


def tuned_config(cfg: RenderConfig, counts, k1: int | None = None,
                 safety: float = 1.2, round_to: int = 1024) -> RenderConfig:
    """RenderConfig with scene-tuned pools and table budget from a
    ``measure_counts`` result; ``safety`` inflates every measured
    population and the table budget."""
    counts = np.asarray(counts)
    n = int(counts.shape[0])
    counts_live = counts[counts > 0]
    span_cap = cfg.num_tiles
    if cfg.max_tiles_per_gaussian > 0:
        span_cap = min(span_cap, cfg.max_tiles_per_gaussian)

    best = None
    for k1c in [k1] if k1 else [1, 2, 4]:
        for ratio in (2.0, 1.5, 1.3):
            cap, ladder, huge = _ladder_capacity(
                counts_live, n, k1c, span_cap, safety, round_to,
                ratio=ratio,
            )
            # the JAX cost model: slots, half a slot per pool entry and
            # ~16k slot-equivalents per tier
            entries = sum(c for _, c in ladder) + huge
            score = cap + 0.5 * entries + 16384 * (len(ladder) + 1)
            if best is None or score < best[0]:
                best = (score, cap, k1c, ladder, huge)
    _, cap, k1c, ladder, huge = best

    # bbox counts bound the (tight-culled) live rows, so this budget never
    # truncates on the measured poses
    live_rows = int(np.minimum(counts_live, span_cap).sum())
    budget = min(cap, max(_round_up(live_rows * safety, 4096), 4096))
    return cfg.with_(
        dense_small_slots=k1c,
        pool_ladder=ladder,
        pool_huge_entries=huge,
        table_budget_rows=budget,
    )


def binning_overflow(scene, view, proj, cam_pos, cfg: RenderConfig):
    """(overflow, truncated) binning diagnostics for one pose: the guard a
    training or viewing loop runs to detect that the camera or the evolving
    scene has outgrown a tuned config (both 0 in normal operation)."""
    with torch.no_grad():
        splats = project(scene, view, proj, cam_pos, cfg)
        b = binning.bin_splats(splats, cfg)
    return b.overflow, b.truncated


def orbit_probe_poses(center, radius, width, height, n_azimuth: int = 8,
                      radii_scales=(0.7, 1.0, 1.6), fovy: float = 1.0):
    """Probe poses for a moving camera: an orbit ring at several radii.
    Returns (views, projs, cam_positions) as numpy arrays."""
    from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
    from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

    cam = Camera(h=height, w=width)
    cam.fovy = fovy
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    center = np.asarray(center, np.float32)
    views, projs, poss = [], [], []
    for rs in radii_scales:
        for i in range(n_azimuth):
            ang = 2 * np.pi * i / n_azimuth
            eye = center + float(radius) * rs * np.array(
                [np.sin(ang), 0.25, np.cos(ang)], np.float32
            )
            views.append(np.asarray(tf.look_at(eye, center, [0, -1, 0]),
                                    np.float32))
            projs.append(proj)
            poss.append(eye.astype(np.float32))
    return views, projs, poss


def autotune_orbit(scene, cfg: RenderConfig, center=None, radius=None,
                   n_azimuth: int = 8, radii_scales=(0.7, 1.0, 1.6),
                   fovy: float = 1.0, safety: float = 1.2,
                   **kw) -> RenderConfig:
    """``autotune`` over an orbit of probe poses around the scene (several
    azimuths at several radii): covers any camera on or outside the inner
    ring within ``safety`` of the probed footprints."""
    if center is None or radius is None:
        bbox, centroid = scene.aabb()
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
        if center is None:
            center = centroid
        if radius is None:
            radius = max(float(np.linalg.norm(hi - lo)) / 2, 1e-3)
    views, projs, poss = orbit_probe_poses(
        center, radius, cfg.width, cfg.height, n_azimuth, radii_scales, fovy
    )
    return autotune(scene, views, projs, poss, cfg, safety=safety, **kw)


def _capacity_of(cfg: RenderConfig, n: int) -> int:
    """Total duplicate-slot capacity of a tuned config (what the JAX
    binning's cost scales with; read by the fused-path decision)."""
    span_cap = cfg.num_tiles
    if cfg.max_tiles_per_gaussian > 0:
        span_cap = min(span_cap, cfg.max_tiles_per_gaussian)
    cap = cfg.dense_small_slots * n
    for kx, c in cfg.pool_ladder:
        cap += int(kx) * int(c)
    huge = cfg.pool_huge_entries or max(n // cfg.pool_huge_fraction, 32)
    return cap + span_cap * huge


_FUSED_K_GRID = (256, 512, 1024, 2048, 4096, 8192)


def tune_fused(scene, views, projs, cam_positions, cfg: RenderConfig,
               fused: bool | None = None, max_probe_poses: int = 4,
               margin_prefix: float = 1.15, margin_residual: float = 1.5,
               margin_grad: float = 1.15) -> RenderConfig:
    """Decide and size the fused prefix/residual path from measured
    per-tile saturation (one ``probe_forward`` per probe pose):

      * fused_grad iff (processed rows + N) < 0.6 * slot capacity (the JAX
        rule: the compact id fold against the slot-dense fold);
      * prefix_rows K from a grid minimizing sum(min(count, K)) + 1.4 *
        residual rows(K), else one pass (K = 0) when no K beats 0.9x the
        full gather;
      * the four budgets with margins; ``truncated`` and
        ``grad_rows_dropped`` report a later pose that outgrows them.

    fused=True forces the path, False returns ``cfg``, None decides."""
    if fused is False:
        return cfg
    chunk = binning.KERNEL_CHUNK
    n = int(scene.xyz.shape[0])
    poses = list(zip(views, projs, cam_positions))[:max_probe_poses]
    counts_l, proc_l, sat_l = [], [], []
    for v, p, c in poses:
        with torch.no_grad():
            splats = project(scene, v, p, c, cfg)
        counts, processed, sat, _ = probe_forward(splats, cfg)
        counts_l.append(counts.cpu().numpy().astype(np.int64))
        proc_l.append(processed.cpu().numpy().astype(np.int64))
        sat_l.append(sat.cpu().numpy())

    proc_tot = max(int(p.sum()) for p in proc_l)
    if fused is None and proc_tot + n >= 0.6 * _capacity_of(cfg, n):
        return cfg  # dead weight too small for the compact fold to win

    live = max(int(c.sum()) for c in counts_l)
    best = (0.9 * live, 0)  # single-pass fallback threshold
    for k in _FUSED_K_GRID:
        kb = rb = 0
        for counts, processed, sat in zip(counts_l, proc_l, sat_l):
            fin = (counts <= k) | (sat & (processed <= k))
            kb = max(kb, int(np.minimum(counts, k).sum()))
            rb = max(rb, int(np.where(fin, 0, counts - k).sum()))
        score = kb + 1.4 * rb
        if score < best[0]:
            best = (score, k)
    k = best[1]

    kb_m = rb_m = g1_m = unfin_m = 0
    for counts, processed, sat in zip(counts_l, proc_l, sat_l):
        if k > 0:
            fin = (counts <= k) | (sat & (processed <= k))
            kb_m = max(kb_m, int(np.minimum(counts, k).sum()))
            rb_m = max(rb_m, int(np.where(fin, 0, counts - k).sum()))
            unfin_m = max(unfin_m, int(np.count_nonzero(~fin)))
            g1_m = max(g1_m, int(np.minimum(processed, k + chunk).sum()))
        else:
            kb_m = max(kb_m, int(counts.sum()))
            g1_m = max(g1_m, int(processed.sum()))
    return cfg.with_(
        fused_grad=True,
        prefix_rows=k,
        prefix_budget_rows=_round_up(kb_m * margin_prefix, 4096),
        residual_budget_rows=(
            _round_up(rb_m * margin_residual + 4096, 4096) if k else 0
        ),
        grad_budget_rows=_round_up(g1_m * margin_grad, chunk),
        # residual-pass gradient rows: residual rows + up to 2 slack windows
        # per unfinished tile, with margin
        grad_residual_budget_rows=(
            _round_up(
                (rb_m + 2 * chunk * (unfin_m + 8)) * margin_grad, chunk
            )
            if k
            else 0
        ),
    )


def autotune(scene, views, projs, cam_positions, cfg: RenderConfig,
             probe: bool = False, probe_margin: float = 1.1,
             fused: bool | None = False, **kw) -> RenderConfig:
    """``measure_counts`` + ``tuned_config`` in one call.

    probe=True also bins once per pose under the tuned config and
    re-tightens table_budget_rows to the measured live duplicate count
    times ``probe_margin``.  ``fused`` (None: decide, True: force) then
    runs ``tune_fused`` on the tuned config; ``kw`` goes to
    ``tuned_config``."""
    counts = measure_counts(scene, views, projs, cam_positions, cfg)
    tuned = tuned_config(cfg, counts, **kw)
    if probe:
        live = 0
        for v, p, c in zip(views, projs, cam_positions):
            with torch.no_grad():
                splats = project(scene, v, p, c, tuned)
                b = binning.bin_splats(splats, tuned)
            live = max(live, int(b.num_duplicates))
        rows = max(_round_up(int(live * probe_margin), 4096), 4096)
        tuned = tuned.with_(
            table_budget_rows=min(rows, tuned.table_budget_rows)
        )
    if fused is not False:
        # the fused probe runs a full-table train forward under the tuned
        # table budget
        tuned = tune_fused(
            scene, views, projs, cam_positions, tuned, fused=fused
        )
    return tuned
