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
    aux dict (duplicates, overflow, truncation, mean transmittance);
  * ``span`` and ``count``: spans around the render's stages and counters
    beside them (``SpanRecord``, ``Recorder``), recorded inside
    ``collect()`` and while a ``torch.profiler`` session runs, and
    nowhere else; a session's records are kept until ``take_profiled()``
    or the next session's first span.

Spans.  A span has a name, its own id, its parent (the span open on its
thread when it began) and a request id shared by every span of one
``render`` call, forward and backward.  Its host ends are stamped with
``time.time_ns()``, the clock of the profiler's events (kineto converts
both the host's and the card's timestamps to Unix-epoch nanoseconds), so a
span and a device operation compare directly.  On a CUDA device each end
also records a timing event on the current stream; the events are read
only by ``Recorder.resolve()``, after the caller's last synchronize.
Recording off, ``span`` and ``count`` check two flags (``collect()``'s and
the profiler's), note that no session runs, and do nothing else: no event, no allocation, no device
read, no autograd node.  Counters take host integers only: reading a
device value would synchronize.

The stages of ``ops/render.py``, their names the same on the classic and
the fused path: ``render`` (the call; parent of the next three),
``project``, ``bin``, ``blend``; in the backward ``blend_bwd``, ``fold``
and ``project_bwd`` (from the packed table's gradient to the scene's,
marked by identity autograd nodes that exist only while recording is on).
Counter ``bin.pairs``: the (tile, splat) pairs after the tight cull.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CUDA
    activity too where a card is present) and write the trace to
    ``log_dir/trace.json``, the spans recorded during the block on a track
    of their own (``SPAN_TRACK``), on the kernels' clock.  Yields the
    profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with collect() as rec, profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, rec.resolve())


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


# ---- spans and counters

SPAN_TRACK = "Program spans"  # the Chrome trace's process of the spans


@dataclasses.dataclass
class SpanRecord:
    """One span.  ``start_ns`` / ``end_ns``: host clock (``time.time_ns``,
    the profiler's).  After ``Recorder.resolve()``, on a CUDA device:
    ``stream_ms`` the card's time between the span's two events on its
    stream (None off the card)."""

    name: str
    id: int
    parent: int | None
    request: int | None
    start_ns: int
    end_ns: int | None = None
    events: tuple | None = None  # (start, end, device) on a CUDA device
    stream_ms: float | None = None


class Recorder:
    """The spans (in the order they began) and counters recorded while it
    was the active recorder."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.counts: collections.Counter = collections.Counter()
        # backward spans opened in one autograd node and closed in another,
        # by (request, name)
        self.pending: dict = {}

    def resolve(self) -> list[SpanRecord]:
        """Read the spans' CUDA events into ``stream_ms``.  Call after the
        last synchronize of the recorded work: ``elapsed_time`` waits for
        nothing and raises on an event not yet reached."""
        for r in self.records:
            if r.events is not None and r.end_ns is not None:
                r.stream_ms = r.events[0].elapsed_time(r.events[1])
        return self.records

    def stream_ms(self, name: str) -> float | None:
        """The summed stream time of the closed spans ``name``; None when
        none has device events (off the card, or no such span)."""
        times = [r.stream_ms for r in self.records
                 if r.name == name and r.stream_ms is not None]
        return sum(times) if times else None


_local = threading.local()
_collecting: list[Recorder] = []  # collect()'s recorders, innermost last
_profiled = Recorder()  # what profiler sessions outside collect() record
_profiler_was_off = False  # a span came while no session ran
_ids = itertools.count(1)
_requests = itertools.count(1)
_NULL = contextlib.nullcontext()


def _active() -> Recorder | None:
    global _profiled, _profiler_was_off
    if _collecting:
        return _collecting[-1]
    if not _autograd_profiler._is_profiler_enabled:
        _profiler_was_off = True
        return None
    if _profiler_was_off:
        # a new session: the records of the last one go
        _profiled, _profiler_was_off = Recorder(), False
    return _profiled


def recording() -> bool:
    """Whether spans and counters are being recorded now."""
    return _active() is not None


@contextlib.contextmanager
def collect():
    """Record spans and counters for the enclosed block, on every thread;
    yields the ``Recorder`` (resolve it after the last synchronize)."""
    rec = Recorder()
    _collecting.append(rec)
    try:
        yield rec
    finally:
        _collecting.remove(rec)


def take_profiled() -> Recorder:
    """What the spans and counters recorded under a ``torch.profiler``
    session outside ``collect()`` since the last call: the recorder, and
    a fresh one in its place."""
    global _profiled
    rec, _profiled = _profiled, Recorder()
    return rec


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(rec: Recorder, name: str, device, request, parent_stack):
    parent = parent_stack[-1] if parent_stack else None
    if request is None and parent is not None:
        request = parent.request
    events = None
    device = None if device is None else torch.device(device)
    start_ns = time.time_ns()
    if device is not None and device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True), device)
        events[0].record(torch.cuda.current_stream(device))
    r = SpanRecord(name, next(_ids), parent.id if parent else None,
                   request, start_ns, events=events)
    rec.records.append(r)
    return r


def _close(r: SpanRecord) -> None:
    if r.events is not None:
        r.events[1].record(torch.cuda.current_stream(r.events[2]))
    r.end_ns = time.time_ns()


class _Span:
    __slots__ = ("rec", "name", "device", "request", "record")

    def __init__(self, rec, name, device, request):
        self.rec, self.name, self.device, self.request = \
            rec, name, device, request

    def __enter__(self):
        stack = _stack()
        self.record = _open(self.rec, self.name, self.device, self.request,
                            stack)
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc):
        _stack().pop()
        _close(self.record)
        return False


def span(name: str, device=None, request: int | None = None,
         new_request: bool = False):
    """Context manager: a span ``name`` around the enclosed block, its
    events on ``device``'s current stream when that is a CUDA device.
    ``request`` names its request (a backward span passes its forward's),
    ``new_request`` starts one; otherwise it takes its parent's."""
    rec = _active()
    if rec is None:
        return _NULL
    if new_request:
        request = next(_requests)
    return _Span(rec, name, device, request)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    rec = _active()
    if rec is not None:
        rec.counts[name] += n


def request() -> int | None:
    """The request of the innermost span open on this thread (None when
    recording is off or no span is open): a forward keeps it for its
    backward, which autograd runs on another thread."""
    if not recording():
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1].request if stack else None


class _BackwardMark(torch.autograd.Function):
    """Identity on its tensors; calls ``hook`` once autograd has their
    gradients."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.hook()
        return (None, *gs)


def _marked(tensors, hook):
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return tensors
    return _BackwardMark.apply(hook, *tensors)


def open_in_backward(name: str, tensors, device=None):
    """``tensors`` unchanged; while recording, behind an identity node
    whose backward opens span ``name`` of the current request, for
    ``close_in_backward`` to close.  Builds no node when off."""
    rec = _active()
    if rec is None:
        return tensors
    req = request()

    def hook():
        if (req, name) not in rec.pending:
            rec.pending[req, name] = _open(
                rec, name, device, req, getattr(_local, "stack", None))

    return _marked(tensors, hook)


def close_in_backward(name: str, tensors):
    """``tensors`` unchanged; while recording, behind an identity node
    whose backward closes the span ``open_in_backward`` opened for the
    current request (nothing when none is open)."""
    rec = _active()
    if rec is None:
        return tensors
    req = request()

    def hook():
        opened = rec.pending.pop((req, name), None)
        if opened is not None:
            _close(opened)

    return _marked(tensors, hook)


def _add_spans_to_chrome_trace(path: str, records) -> None:
    """Append ``records`` to the Chrome trace at ``path`` as complete
    events of process ``SPAN_TRACK``, one row per request, on the trace's
    own clock (its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc.setdefault("traceEvents", [])
    for r in records:
        if r.end_ns is None:
            continue
        events.append({
            "ph": "X", "cat": "program_span", "name": r.name,
            "pid": SPAN_TRACK, "tid": r.request or 0,
            "ts": (r.start_ns - base) / 1e3,
            "dur": (r.end_ns - r.start_ns) / 1e3,
            "args": {"id": r.id, "parent": r.parent,
                     "request": r.request, "stream_ms": r.stream_ms},
        })
    with open(path, "w") as f:
        json.dump(doc, f)
