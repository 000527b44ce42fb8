"""Finds a cell's parts by name, from ``BENCHMARK.json`` and the files
beside the harness, so that a new configuration, mix, cell or per-layer
metric is a new file and entry, and no edit:

  configs/<config>.json   the configuration (``file`` in BENCHMARK.json)
  reference/<name>.py     the plain reference of the primitive that a
                          configuration names by ``"reference": "<name>"``
  traffic/<mix>.json      the traffic mix
  limits/<cell>.json      the limit of each number the judge compares
  metrics/<metric>.py     a per-layer metric's reader, ``read(run)``;
                          ``<a>.<b>`` falls back to ``metrics/<a>.py``

A configuration also holds ``"render"``, the fields of the program's
``RenderConfig`` beside its width and height; the run builds
``RenderConfig(width=..., height=..., **config["render"])``, so an unknown
field fails its set-up.

A reference module imports nothing of the program and provides:

  LEAVES        the names of the scene's leaves, in the program's order
  make_scene(cfg, seed, device)
                {leaf: tensor} made on ``device`` from the seed: the
                inputs handed to both the program and the reference
  render(leaves, view, proj, cam_pos, width, height, grad=False,
         tf32=False)
                (image (H, W, 3), loss sum(image**2), the work the inputs
                need {"rows", "fragments", "tiles"}); with ``grad`` the
                loss's gradient in each leaf's ``.grad``; ``tf32`` takes
                its products in TF32 (the control)
  train_steps(scene, poses, mix, width, height, tf32=False)
                one SGD step of the mix per pose: (losses, first gradient,
                final leaves, first image, the work of each step)
  WORK          the counts per unit of that work that ``roofline.py``
                reads (FP32 operations per fragment and per splat, forward
                and backward; bytes per row and per pixel, forward and
                backward; pixels per tile)
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    """BENCHMARK.json, read from the checkout ``root``."""

    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def reference(self, config: dict):
        """The reference module that ``config`` names."""
        return _load(self.dir / "reference" / f"{config['reference']}.py",
                     "benchmark_reference_")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric."""
        base = self.dir / "metrics"
        path = base / f"{metric}.py"
        if not path.exists():
            path = base / f"{metric.split('.')[0]}.py"
        return _load(path, "benchmark_metric_").read


def _load(path: Path, prefix: str):
    """The module of the Python file ``path``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
