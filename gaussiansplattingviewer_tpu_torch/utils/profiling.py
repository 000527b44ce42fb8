"""Tracing / profiling utilities.

The PyTorch port of the JAX package's ``utils/profiling.py``.  The
reference's only observability is an imgui fps readout (main.py:949) and
stray prints.  Here:
  * ``trace(dir)``: context manager around ``torch.profiler`` (CPU
    activity, and CUDA activity when a card is present) writing a Chrome /
    Perfetto trace into ``dir``;
  * ``FrameTimer``: throughput counters (ms/frame, Mpix/s, splats/s) that
    end each measurement with a hard sync (``hard_sync``);
  * ``render_stats``: per-frame counter summary from ``render_with_aux``'s
    aux dict (duplicates, overflow, truncation, mean transmittance).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CUDA
    activity too where a card is present) and write the trace to
    ``log_dir/trace.json``.  Yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def hard_sync(out) -> None:
    """Block until ``out`` is really computed: ``torch.cuda.synchronize``
    on the device of its first CUDA tensor (CPU work is synchronous)."""
    for leaf in _leaves(out):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class FrameTimer:
    """Measure steady-state frame time of a callable producing tensors.

    Example:
        timer = FrameTimer(lambda: render(scene, ...), pixels=w*h)
        stats = timer.run(iters=20)   # {"ms_per_frame": ..., "mpix_s": ...}
    """

    def __init__(self, fn, pixels: int | None = None, splats: int | None = None):
        self.fn = fn
        self.pixels = pixels
        self.splats = splats

    def run(self, iters: int = 10, warmup: int = 2) -> dict:
        out = None
        for _ in range(max(warmup, 1)):
            out = self.fn()
        hard_sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.fn()
        hard_sync(out)
        dt = (time.perf_counter() - t0) / iters
        stats = {"ms_per_frame": dt * 1000.0, "fps": 1.0 / dt}
        if self.pixels:
            stats["mpix_s"] = self.pixels / dt / 1e6
        if self.splats:
            stats["msplats_s"] = self.splats / dt / 1e6
        return stats


def render_stats(aux: dict) -> dict:
    """Summarize the aux dict from render_with_aux into host scalars."""
    out = {}
    if "transmittance" in aux:
        out["mean_transmittance"] = float(torch.as_tensor(
            aux["transmittance"]).detach().cpu().numpy().mean())
    for k in ("num_duplicates", "overflow", "truncated"):
        if k in aux:
            out[k] = int(aux[k])
    return out
