"""The readings the limits are set from: runs of one cell in one process,
on many seeds, of the program as it is, of the control (the program in
the next precision below the configuration's: TF32 for float32 with TF32
off) and of the faults the cell can have (``cell.FAULTS``), each judged as
a benchmark run judges it.  The benchmark's own runs never run these.

  python3 -m benchmark.prove --workload <name> --seeds 1,2,3
      [--modes program,control,fault:half_batch] [--seconds 2]
      [--out chiprun_out/prove.jsonl]

Prints, and appends to ``--out``, one JSON line per run: the mode, the
seed, ``correct`` and each compared number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import cell, cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prove: no CUDA card", file=sys.stderr)
        return 3
    spec = cells.Spec(Path.cwd())
    w = spec.cell(args.workload)
    config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    limits = spec.limits(w["name"])
    ref = spec.reference(config)
    for mode in args.modes.split(","):
        fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            if mode == "control":
                out = cell.control(config, ref, mix, limits, seed, "cuda")
                line = {}
            else:
                out = cell.run(config, ref, mix, limits, seed,
                               args.seconds, False, "cuda", t0, fault=fault)
                line = {"route": out.route, "setup_s": out.setup_s,
                        "metrics": out.metrics, "needed": out.needed}
            line = {"workload": w["name"], "mode": mode, "seed": seed,
                    "correct": out.correct, **line,
                    "seconds": time.perf_counter() - t0,
                    "leaf_gaps": getattr(out, "leaf_gaps", None),
                    **{k: v["value"] for k, v in out.checks.items()}}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            del out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
