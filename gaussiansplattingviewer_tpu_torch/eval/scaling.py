"""Tiles/s scaling efficiency of the tile-row-sharded render, measured one
shard at a time on one card.

The port of the JAX repository's ``scripts/scaling.py``.  One card cannot
run N shards at once, so each shard's exact program (``_render_band`` of
``parallel/sharded_render.py`` with a concrete shard index) is timed
serially, with CUDA events on the card.  With N cards every shard runs
concurrently, so the projected N-card frame time is max_i t_i plus any
collective time (inference has none: the image stays row-sharded).

Both row assignments run on a deliberately TOP-HEAVY scene (85% of the
splats pushed into the lower image rows, like ground against sky), with
the table budget sized to the frame by ``autotune(probe=True)``:
contiguous bands, where the cards owning sky rows idle, and interleaved
(round-robin) rows; each with and without the band pre-cull before
projection, for N = 1, 2, 4, 8.  Unless ``--skip-exchange``, exchange mode
(splats sharded, ``_exchange_parts`` partitions each shard's projected
splats by destination band; the all-to-all's receive side then bins and
blends) runs for N = 2, 4, 8: its per-shard time is the send program plus
the receive program, and the bytes each card would send are counted.

Per run row:
  * ``scaling_eff`` = T1 / (N * max_i t_i), strong-scaling efficiency
    against the single-shard frame time, the headline;
  * ``balance_eff`` = sum_i t_i / (N * max_i t_i), load balance only;
  * ``projected_tiles_per_s`` = tiles / max_i t_i;
  * ``dropped``: splats the shards' budgets dropped (JAX's budgets: band
    compaction 2.5, pre-cull 2.0, exchange 3.0 times the band's share of
    the tile rows), summed over the shards; a row that dropped splats
    timed less work than its frame needs and renders another image;
  * ``max_abs_vs_render``: the assembled bands against ``render()``
    (where nothing dropped, within early_stop_transmittance of its scale,
    ``render_max_abs``: a band's 256-row windows can end at other rows
    than the image's).

No collective is timed: the JAX script modeled its all-to-all and the
training step's gradient all-reduce from TPU link rates, which are not
this machine's.  The all-reduce's bytes per card are reported and its time
is null until NCCL is measured across several cards.

  python -m gaussiansplattingviewer_tpu_torch.eval.scaling \\
      [--n-splats N] [--width W] [--height H] [--iters I] \\
      [--skip-exchange] [--device cuda] [--out PATH]

Defaults: 1M splats at 1920x1080, 8 timed calls per shard on the card;
20k splats at 512x256, 6 calls, with ``--device cpu``.  Writes --out
(default chiprun_out/scaling_<device>.json) with the card's name and power
limit and prints a table; non-zero exit without a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import random_scene
from gaussiansplattingviewer_tpu_torch.models.gaussians import _FIELDS
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.blend import blend_tiles
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render_with_aux,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.parallel.sharded_render import (
    _exchange_parts,
    _render_band,
    _rows_per_shard,
    _splats_from_received,
    band_image,
    band_pixel_rows,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

SHARD_COUNTS = (1, 2, 4, 8)
EXCHANGE_COUNTS = (2, 4, 8)
# (interleaved, precull) per N > 1; N = 1 runs the plain band only
ASSIGNMENTS = ((False, False), (True, False), (False, True), (True, True))
PRECULL_BUDGET_FACTOR = 2.0
EXCHANGE_BUDGET_FACTOR = 3.0


def top_heavy_scene(n: int):
    """``scaling.py:100-108``'s scene: SH 1, with ~85% of the splats pushed
    into the bottom of the view (y is down in image space; world +y maps
    down with the [0, -1, 0] up)."""
    scene = random_scene(n, sh_degree=1, seed=0, extent=2.0,
                         mean_scale=0.03)
    xyz = scene.xyz.numpy().copy()
    heavy = np.random.default_rng(1).uniform(size=n) < 0.85
    xyz[heavy, 1] = np.abs(xyz[heavy, 1]) * 0.5 + 1.0
    scene.xyz = torch.from_numpy(xyz)
    return scene


def efficiencies(t_shards, t1: float, num_tiles: int) -> dict:
    """The run row's figures from its shard times (seconds) and the
    single-shard time ``t1``, as ``scaling.py`` computes them."""
    n_dev = len(t_shards)
    t_max = max(t_shards)
    return {
        "projected_ms_per_frame": round(t_max * 1e3, 2),
        "scaling_eff": round(t1 / (n_dev * t_max), 3),
        "balance": round(sum(t_shards) / n_dev / t_max, 3),
        "balance_eff": round(sum(t_shards) / (n_dev * t_max), 3),
        "projected_tiles_per_s": round(num_tiles / t_max, 1),
    }


def _timer(dev, iters: int):
    """Seconds per call of fn(*a, **kw) over ``iters`` calls after one
    warm-up call (CUDA events on the card, the host clock on the CPU);
    returns (seconds, the last output)."""

    def timed(fn, *a, **kw):
        with torch.no_grad():
            out = fn(*a, **kw)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    out = fn(*a, **kw)
                stop.record()
                torch.cuda.synchronize(dev)
                return start.elapsed_time(stop) / 1e3 / iters, out
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*a, **kw)
            return (time.perf_counter() - t0) / iters, out

    return timed


def _vs_render(bands, ref, cfg: RenderConfig, interleaved: bool) -> float:
    """max|band rows - the same rows of render()| over every shard."""
    n_dev = len(bands)
    worst = 0.0
    for idx, band in enumerate(bands):
        rows = band_pixel_rows(cfg, n_dev, idx, interleaved).to(band.device)
        keep = rows < cfg.height
        if keep.any():  # a shard past the image renders padding only
            got = band[keep][:, :cfg.width]
            worst = max(worst, float((got - ref[rows[keep]]).abs().max()))
    return worst


def run(n: int, width: int, height: int, iters: int, skip_exchange: bool,
        device) -> dict:
    """Every run row of the harness on ``device``."""
    dev = resolve_device(device)
    host_scene = top_heavy_scene(n)
    scene = host_scene.pad_to_multiple(1024).to(dev)
    cam = Camera(h=height, w=width)
    cam.fovy = 1.2
    eye = np.array([0, 0, 4.0], np.float32)
    view = np.asarray(tf.look_at(eye, [0, 0, 0], [0, -1, 0]), np.float32)
    proj = np.asarray(cam.get_project_matrix(), np.float32)
    # the dense bottom rows list more rows than the default table budget
    # (8 per splat) holds: size it to the frame, as bench does, so that
    # neither the frame nor a band truncates
    cfg = autotune(scene, [view], [proj], [eye],
                   RenderConfig(width=width, height=height), probe=True)
    timed = _timer(dev, iters)
    with torch.no_grad():
        ref, aux = render_with_aux(scene, view, proj, eye, cfg, device=dev)

    results = {
        "config": {
            "width": cfg.width, "height": cfg.height, "n_splats": n,
            "num_tiles": cfg.num_tiles, "iters": iters,
            "device": str(dev), "table_budget_rows": cfg.table_budget_rows,
            "render_truncated": int(aux["truncated"]),
            "render_max_abs": float(ref.abs().max()),
            "method": (
                "per-shard programs timed serially on one device; "
                "projected N-card frame = max_i t_i (inference is "
                "collective-free: the image stays row-sharded); "
                "efficiency = T1 / (N * max_i t_i)"),
        },
        "runs": [],
    }

    t1 = None
    for n_dev in SHARD_COUNTS:
        rows = _rows_per_shard(cfg, n_dev)
        for interleaved, precull in ASSIGNMENTS:
            if n_dev == 1 and (interleaved or precull):
                continue
            fn = functools.partial(
                _render_band, cfg=cfg, rows=rows,
                row_stride=n_dev if interleaved else 1,
                precull_budget_factor=PRECULL_BUDGET_FACTOR if precull
                else None, return_aux=True)
            t_shards, bands, dropped = [], [], 0
            for idx in range(n_dev):
                t, (band, aux) = timed(fn, scene, view, proj, eye, idx=idx)
                t_shards.append(t)
                bands.append(band)
                dropped += int(aux["dropped"])
            if n_dev == 1:
                t1 = t_shards[0]
            key = ("precull-" if precull else "") + (
                "interleaved" if interleaved else "contiguous")
            row = {"n_dev": n_dev, "assignment": key,
                   "shard_ms": [round(t * 1e3, 3) for t in t_shards],
                   "dropped": dropped,
                   **efficiencies(t_shards, t1, cfg.num_tiles),
                   "max_abs_vs_render": _vs_render(bands, ref, cfg,
                                                   interleaved)}
            results["runs"].append(row)
            print(f"n_dev={n_dev} {key:20s} max {max(t_shards) * 1e3:9.3f} "
                  f"ms  SCALING_EFF={row['scaling_eff']:.3f}  "
                  f"balance_eff={row['balance_eff']:.3f}", flush=True)

    for n_dev in () if skip_exchange else EXCHANGE_COUNTS:
        for interleaved in (False, True):
            row = _exchange_row(host_scene, view, proj, eye, cfg, n_dev,
                                interleaved, dev, timed, t1, ref)
            results["runs"].append(row)
            print(f"n_dev={n_dev} {row['assignment']:20s} max "
                  f"{row['projected_ms_per_frame']:9.3f} ms  "
                  f"SCALING_EFF={row['scaling_eff']:.3f} (no all-to-all)",
                  flush=True)

    # a replicated-scene training step all-reduces the whole gradient: a
    # ring moves 2 (N - 1) / N of its bytes per card
    grad_bytes = sum(getattr(scene, f).numel() * 4 for f in _FIELDS)
    results["train_comm"] = {
        "grad_bytes": int(grad_bytes),
        "ring_allreduce_bytes_per_card": {
            str(nd): int(2 * (nd - 1) / nd * grad_bytes)
            for nd in EXCHANGE_COUNTS},
        "ring_allreduce_ms": None,
        "note": "not measured: NCCL across several cards",
    }
    return results


def _exchange_row(host_scene, view, proj, eye, cfg, n_dev, interleaved, dev,
                  timed, t1, ref) -> dict:
    """Exchange mode: splats sharded; per-shard work = project(N / n_dev) +
    the band partition (send), then bin and blend the received band splats
    (receive).  The all-to-all itself is not run: its bytes are counted."""
    rows = _rows_per_shard(cfg, n_dev)
    stride = n_dev if interleaved else 1
    n = len(host_scene)
    per = -(-n // n_dev)
    sc = host_scene.pad_to(per * n_dev)
    shards = [sc.select(slice(i * per, (i + 1) * per)).to(dev)
              for i in range(n_dev)]

    def send(s):
        return _exchange_parts(project(s, view, proj, eye, cfg), cfg, rows,
                               n_dev, EXCHANGE_BUDGET_FACTOR,
                               row_stride=stride)

    def recv(rows_rx, valid_rx, idx):
        splats = _splats_from_received(rows_rx, valid_rx)
        row0 = idx if interleaved else idx * rows
        binned = binning.bin_splats(splats, cfg, row_offset=row0,
                                    local_rows=rows, row_stride=stride)
        return blend_tiles(cfg, rows, stride, binned.table,
                           binned.tile_starts, binned.tile_counts, row0)

    t_send, parts = [], []
    for s in shards:
        t, out = timed(send, s)
        t_send.append(t)
        parts.append(out)
    t_recv, send_bytes, bands = [], [], []
    for i in range(n_dev):
        rows_rx = torch.cat([p[0][i] for p in parts])
        valid_rx = torch.cat([p[1][i] for p in parts])
        t, (rgb, trans) = timed(recv, rows_rx, valid_rx, i)
        t_recv.append(t)
        bands.append(band_image(rgb, trans, cfg, rows))
        # what this card sends to the others (its own slice stays): the
        # packed rows and the validity mask, as the all-to-alls move them
        rows_i, valid_i = parts[i][0], parts[i][1]
        send_bytes.append((rows_i[0].numel() * 4 + valid_i[0].numel())
                          * (n_dev - 1))
    t_shards = [a + b for a, b in zip(t_send, t_recv)]
    kind = "interleaved" if interleaved else "contiguous"
    return {"n_dev": n_dev, "assignment": f"exchange-{kind}",
            "shard_ms": [round(t * 1e3, 3) for t in t_shards],
            "send_ms": [round(t * 1e3, 3) for t in t_send],
            "recv_ms": [round(t * 1e3, 3) for t in t_recv],
            "max_send_bytes": int(max(send_bytes)),
            "all_to_all_ms": None,
            "dropped": sum(int(p[2]) for p in parts),
            **efficiencies(t_shards, t1, cfg.num_tiles),
            "max_abs_vs_render": _vs_render(bands, ref, cfg, interleaved)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-splats", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--skip-exchange", action="store_true",
                    help="skip the exchange-mode rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/scaling_<device>.json")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"scaling: {e}", file=sys.stderr)
        return 2
    # the card: a realistic load; the CPU: small enough for the plain
    # versions
    on_card = dev.type == "cuda"
    results = run(args.n_splats or (1_000_000 if on_card else 20_000),
                  args.width or (1920 if on_card else 512),
                  args.height or (1080 if on_card else 256),
                  args.iters or (8 if on_card else 6), args.skip_exchange,
                  dev)
    if on_card:
        from gaussiansplattingviewer_tpu_torch.eval.gradcheck import (
            card_line,
        )

        results["config"]["card"] = card_line()
    else:
        results["config"]["card"] = "cpu"
    out = args.out or os.path.join("chiprun_out", f"scaling_{dev.type}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
