"""Shared fixtures of the benchmark's CPU tests: a toy size of each
configuration, so a run of a cell takes seconds on the CPU."""

from __future__ import annotations

from pathlib import Path

import pytest

from benchmark import cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="session")
def spec():
    return cells.Spec(ROOT)


def toy(config: dict, dense: bool = False) -> dict:
    """The configuration at 3,000 splats and 96x64 (``dense``: 6,000
    splats large enough that the autotuner takes the fused path)."""
    out = dict(config)
    out.update(n_splats=6000 if dense else 3000,
               width=128 if dense else 96, height=96 if dense else 64,
               extent=1.5, mean_scale=0.2 if dense else 0.03,
               eye=[0.0, 0.0, 4.0])
    return out

