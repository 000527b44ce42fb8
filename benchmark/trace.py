"""The traced run's device record: ``torch.profiler`` with CUDA activity
only (tracing host operations as well doubled the 1M step's window), over
the measured window, read into what the per-layer metrics need."""

from __future__ import annotations

import collections
import contextlib
import re

BLEND_KERNELS = ("tile_raster_fwd_kernel", "tile_raster_bwd_kernel")
COPIES = ("Memcpy", "Memset")


@contextlib.contextmanager
def device_trace(enabled: bool):
    """Yields the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device operation, by start."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return sorted(out, key=lambda ev: ev[1])


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def summarize(events, top: int = 10) -> dict:
    """busy_s (the union of the operations' intervals), kernel launches,
    blend kernel seconds and the breakdown: the ``top`` device operations
    by time and the ``top`` longest idle gaps, each named by the operation
    that ended it."""
    busy = 0.0
    reach = float("-inf")
    gaps = []
    by_name = collections.Counter()
    kernels = 0
    blend_s = 0.0
    for name, start, end in events:
        if reach != float("-inf") and start > reach:
            gaps.append(("before_" + _label(name), start - reach))
        if end > reach:
            busy += end - max(start, reach)
            reach = end
        by_name[_label(name)] += end - start
        if not name.startswith(COPIES):
            kernels += 1
        if any(k in name for k in BLEND_KERNELS):
            blend_s += end - start
    gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": busy,
        "kernels": kernels,
        "blend_s": blend_s,
        "breakdown": {
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps[:top]],
        },
    }
