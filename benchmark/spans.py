"""The program's own spans and counters in the traced run.

The port records spans at its render's stage boundaries and counters
beside them (``utils/profiling.py``) while a ``torch.profiler`` session
runs, so the traced window records them and the untraced run records
nothing.  Here they are read into per-layer metrics, per step or
frame.

A program without the recorder gives None for every metric here, as does
a run off the card (a span's stream time comes from CUDA events).
"""

from __future__ import annotations


def recorder(run):
    """The recorder of the traced window (read once, kept on ``run``), or
    None: untraced, off the card, or a program that records no spans."""
    if not getattr(run, "events", None):
        return None
    if not hasattr(run, "program_spans"):
        from gaussiansplattingviewer_tpu_torch.utils import profiling

        take = getattr(profiling, "take_profiled", None)
        rec = take() if take is not None else None
        if rec is not None:
            rec.resolve()
        run.program_spans = rec if rec is not None and rec.records else None
    return run.program_spans


def stage_ms(run, name: str) -> float | None:
    """Stream time of the spans ``name`` per step or frame (ms)."""
    rec = recorder(run)
    if rec is None or not run.steps:
        return None
    total = rec.stream_ms(name)
    return None if total is None else total / run.steps


def per_step(run, counter: str) -> float | None:
    """A counter's total over the window per step or frame."""
    rec = recorder(run)
    if rec is None or not run.steps or counter not in rec.counts:
        return None
    return rec.counts[counter] / run.steps
