"""Run one cell of the benchmark once, on the card this process starts on.

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
      --trace <0|1>

from the root of a checkout of the repository.  The cell, its
configuration, traffic mix, limits and per-layer metrics are found by name
(``cells.py``); the run makes the scene on the card from the seed, runs
the program's autotuner for the cell's poses, warms up the cell's shapes,
measures for ``--seconds`` (``cell.py``), then compares what the timed
path produced with the plain reference (``judge.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``; last comes ``checks``, each compared number beside its
limit, which also end standard error.  Without a card, with fewer cards
than the cell asks for, without the program beside the harness, or when
JAX or the JAX package has been loaded, it prints no result and exits
non-zero.

Every cache the program builds stays in the checkout: the kernels in the
package's own ``_build/`` directory, PyTorch's and Triton's caches under
``.bench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplattingviewer_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (the port's name starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out[0]} if out else {}


def result_line(spec, cell_name: str, out, traced: bool,
                device: dict) -> dict:
    """The contract's JSON object for one finished run."""
    metrics = {}
    if traced:
        for m in spec.per_layer(cell_name):
            value = spec.reader(m["name"])(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(cell_name):
            value = out.setup_s if m["name"] == "setup_s" \
                else out.metrics.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(out.correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = out.trace["breakdown"]
    line["checks"] = out.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")

    from benchmark import cells

    spec = cells.Spec(ROOT)
    cell_spec = spec.cell(args.workload)
    import torch

    # one process with few threads: the host thread dispatches the card's
    # work, and no CPU pool competes with it
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell_spec["chips"]:
        print(f"run: the cell needs {cell_spec['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import gaussiansplattingviewer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run: the program is not beside the harness: {e}",
              file=sys.stderr)
        return 4

    from benchmark import cell, trace

    config = spec.config(cell_spec["config"])
    out = cell.run(config, spec.reference(config),
                   spec.traffic(cell_spec["traffic"]),
                   spec.limits(cell_spec["name"]), args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    out.trace = trace.summarize(out.events) if out.events else None
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell_spec["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        device["busy_s"] = out.trace["busy_s"] if out.trace else 0.0
        device["window_s"] = out.window_s
    card = card_line()
    line = result_line(spec, cell_spec["name"], out, bool(args.trace), device)

    bad = loaded_forbidden()
    if bad:
        print(f"run: {', '.join(bad)} loaded in the run's process",
              file=sys.stderr)
        return 5
    print(f"# {cell_spec['name']} seed {args.seed}: route {out.route}, "
          f"{out.steps} {out.kind} calls in {out.window_s:.3f} s, "
          f"set-up {out.setup_s:.3f} s (" + ", ".join(
              f"{k} {v:.3f} s" for k, v in out.phases.items())
          + f"), {card.get('nvidia_smi', '')}", file=sys.stderr)
    stats = torch.cuda.memory_stats()
    print(f"# allocator: {stats.get('num_device_alloc', 0)} device "
          f"allocations, {stats.get('num_alloc_retries', 0)} retries",
          file=sys.stderr)
    for name, c in out.checks.items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
