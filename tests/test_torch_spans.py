"""PyTorch port: the spans and counters of ``utils/profiling.py`` at the
render's stage boundaries, and the benchmark's readers of them.

Imports neither JAX nor tests/conftest.py's fixtures, so the card's test
here also runs where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_spans.py
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import spans as bench_spans
from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models import random_scene
from gaussiansplattingviewer_tpu_torch.ops import binning
from gaussiansplattingviewer_tpu_torch.ops.projection import project
from gaussiansplattingviewer_tpu_torch.ops.render import (
    render,
    render_with_aux,
)
from gaussiansplattingviewer_tpu_torch.utils import profiling
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera

FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
FORWARD = ("project", "bin", "blend")
BACKWARD = ("blend_bwd", "fold", "project_bwd")
# (backend, RenderConfig overrides): the classic path on the kernels'
# plain versions and on the tile executor, and the fused path in one pass
# and with a prefix and a residual pass
PATHS = {
    "kernel-classic": ("kernel", {}),
    "kernel-fused": ("kernel", dict(fused_grad=True)),
    "kernel-prefix": ("kernel", dict(fused_grad=True, prefix_rows=16,
                                     residual_budget_rows=8192)),
    "tile-classic": ("tile", {}),
}


def _pose(cfg):
    cam = Camera(h=cfg.height, w=cfg.width)
    cam.fovy = 1.0
    eye = np.array([0.3, -0.2, 4.0], np.float32)
    return tf.look_at(eye, [0, 0, 0], [0, -1, 0]), \
        cam.get_project_matrix(), eye


def _scene():
    scene = random_scene(400, sh_degree=1, seed=5, extent=1.2,
                         mean_scale=0.12)
    for f in FIELDS:
        getattr(scene, f).requires_grad_(True)
    return scene


def _step(path, n_renders=1):
    """Render ``n_renders`` times and differentiate sum(img^2): (images,
    the scene's gradients, the last image)."""
    backend, kw = PATHS[path]
    cfg = RenderConfig(width=48, height=32, **kw)
    scene = _scene()
    imgs = []
    for _ in range(n_renders):
        img = render(scene, *_pose(cfg), cfg, backend=backend, device="cpu")
        (img * img).sum().backward()
        imgs.append(img.detach())
    return imgs, {f: getattr(scene, f).grad for f in FIELDS}, img


MARK = "_BackwardMarkBackward"


def _graph(img) -> collections.Counter:
    """The autograd graph behind ``img``: each node's type with the types
    of the nodes it feeds its gradients to, the recording marks contracted
    into their inputs' nodes; and the number of marks."""
    marks = set()

    def children(fn):
        for f, output in fn.next_functions:
            if f is not None and type(f).__name__ == MARK:
                # output i of a mark is its input i
                marks.add(f)
                f = f.next_functions[output][0]
            if f is not None:
                yield f

    out, seen, todo = collections.Counter(), set(), [img.grad_fn]
    while todo:
        fn = todo.pop()
        if fn in seen:
            continue
        seen.add(fn)
        kids = list(children(fn))
        out[type(fn).__name__, tuple(type(f).__name__ for f in kids)] += 1
        todo.extend(kids)
    out[MARK] = len(marks)
    return out


@pytest.mark.parametrize("path", ["kernel-classic", "kernel-prefix",
                                  "tile-classic"])
def test_spans_nest_and_share_their_request(path):
    """Two training renders: per render one ``render`` span, parent of
    ``project``, ``bin`` and ``blend``; the backward's ``blend_bwd``,
    ``fold`` and ``project_bwd`` in that order; every span of a render
    under its request, the backward's too; the six stage spans
    disjoint."""
    with profiling.collect() as rec:
        _step(path, n_renders=2)
    renders = [r for r in rec.records if r.name == "render"]
    assert len(renders) == 2
    assert renders[0].request != renders[1].request
    for top in renders:
        assert top.parent is None and top.end_ns is not None
        mine = [r for r in rec.records if r.request == top.request]
        names = [r.name for r in mine]
        assert names == ["render", *FORWARD, *BACKWARD], names
        by = {r.name: r for r in mine}
        for name in FORWARD:
            assert by[name].parent == top.id
            assert top.start_ns <= by[name].start_ns \
                <= by[name].end_ns <= top.end_ns
        stages = sorted((by[n] for n in (*FORWARD, *BACKWARD)),
                        key=lambda r: r.start_ns)
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns <= b.start_ns, (a.name, b.name)
    assert len({r.id for r in rec.records}) == len(rec.records)
    assert rec.counts["bin.pairs"] > 0
    # no CUDA events on the CPU: no stream time
    assert rec.resolve() and rec.stream_ms("project") is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_recording_off_records_nothing_and_builds_the_same_graph(
        path, monkeypatch):
    """Off (no collect(), no profiler): no span opens, nothing is recorded
    anywhere, and the graph is the one recording on builds less its
    identity marks."""
    profiling.take_profiled()
    with profiling.collect():
        _, _, img_on = _step(path)
    on = _graph(img_on)

    def refuse(*a, **k):
        raise AssertionError("a span opened with recording off")

    monkeypatch.setattr(profiling, "_open", refuse)
    assert not profiling.recording()
    _, _, img_off = _step(path)
    off = _graph(img_off)
    rec = profiling.take_profiled()
    assert not rec.records and not rec.counts
    # one mark at the scene's leaves, one at the packed table
    assert off.pop(MARK) == 0 and on.pop(MARK) == 2
    assert on == off


@pytest.mark.parametrize("path", sorted(PATHS))
def test_recording_changes_no_bit(path):
    """Images and every leaf's gradient equal bit for bit, recording on
    and off."""
    imgs_off, g_off, _ = _step(path)
    with profiling.collect():
        imgs_on, g_on, _ = _step(path)
    assert torch.equal(imgs_on[0], imgs_off[0])
    for f in FIELDS:
        assert torch.equal(g_on[f], g_off[f]), f


@pytest.mark.parametrize("fused", [False, True])
def test_bin_pairs_is_the_presort_duplicate_count(fused):
    """``bin.pairs`` counts the pairs left after the tight cull: the
    presort's ``num_duplicates``, and render_with_aux's where the classic
    table budget truncates nothing."""
    cfg = RenderConfig(width=48, height=32, fused_grad=fused)
    scene = _scene()
    with torch.no_grad():
        splats = project(scene, *_pose(cfg), cfg)
        with profiling.collect() as rec:
            pres = binning.bin_splats_presort(splats, cfg)
        assert rec.counts["bin.pairs"] == int(pres.num_duplicates) > 0
        with profiling.collect() as rec:
            _, aux = render_with_aux(scene, *_pose(cfg), cfg, device="cpu")
    assert int(aux["truncated"]) == 0
    assert rec.counts["bin.pairs"] == int(aux["num_duplicates"])


def test_request_and_counters_are_inert_when_off():
    assert profiling.request() is None
    assert profiling.span("x") is profiling.span("y")  # the shared no-op
    profiling.count("bin.pairs", 3)
    assert not profiling.take_profiled().counts


def test_a_profiler_session_records_and_take_empties_it():
    """Under a torch.profiler session outside collect() the spans go to
    the session's recorder; ``take_profiled`` hands it over; after the
    session nothing more is recorded."""
    from torch.profiler import ProfilerActivity, profile

    profiling.take_profiled()
    cfg = RenderConfig(width=48, height=32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        render(_scene(), *_pose(cfg), cfg, device="cpu")
    with torch.no_grad():
        render(_scene(), *_pose(cfg), cfg, device="cpu")
    rec = profiling.take_profiled()
    assert [r.name for r in rec.records] == ["render", *FORWARD]
    assert not profiling.take_profiled().records


def test_a_new_profiler_session_drops_the_last_ones_records():
    """Records of a session nobody took go when the next session's first
    span opens: the recorder holds one session at most."""
    from torch.profiler import ProfilerActivity, profile

    profiling.take_profiled()
    cfg = RenderConfig(width=48, height=32)
    with torch.no_grad():
        for renders in (2, 1):
            with profile(activities=[ProfilerActivity.CPU]):
                for _ in range(renders):
                    render(_scene(), *_pose(cfg), cfg, device="cpu")
            render(_scene(), *_pose(cfg), cfg, device="cpu")
    rec = profiling.take_profiled()
    assert [r.name for r in rec.records] == ["render", *FORWARD]
    assert rec.counts["bin.pairs"] > 0


def test_trace_writes_the_spans_on_the_kernels_clock(tmp_path):
    """``profiling.trace`` adds the spans as a track of their own to its
    Chrome trace; a CPU operation of the render lies inside the render's
    span there."""
    cfg = RenderConfig(width=48, height=32)
    with torch.no_grad(), profiling.trace(str(tmp_path / "tr")):
        render(_scene(), *_pose(cfg), cfg, device="cpu")
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    mine = [e for e in doc["traceEvents"]
            if e.get("pid") == profiling.SPAN_TRACK]
    assert [e["name"] for e in mine] == ["render", *FORWARD]
    top = mine[0]
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e["name"] == "aten::sort"]
    assert ops
    for e in ops:
        assert top["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
            <= top["ts"] + top["dur"]


class _Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_span_readers_read_nothing_off_the_card():
    """On the CPU (no CUDA events) every new reader gives None, the
    counter too when the run traced nothing on a card."""
    from benchmark import cells

    spec = cells.Spec(Path(__file__).resolve().parents[1])
    cfg = RenderConfig(width=48, height=32)
    profiling.take_profiled()
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        render(_scene(), *_pose(cfg), cfg, device="cpu")
    names = [m["name"] for m in spec.data["per_layer"]
             if m["source"] == "program_span"
             or m["name"].startswith("bin_pairs")]
    assert names
    traced = _Run(events=[("k", 0.0, 1.0)], steps=1)
    untraced = _Run(events=None, steps=1)
    for name in names:
        read = spec.reader(name)
        assert read(untraced) is None, name
        if name.startswith("bin_pairs"):
            assert read(traced) > 0
        else:
            assert read(traced) is None, name


def test_span_readers_divide_the_window_by_its_steps():
    """A stage's stream time and a counter, summed over the window's
    spans, per step; a stage without stream time reads None."""
    rec = profiling.Recorder()
    for i, (name, ms) in enumerate([("bin", 2.0), ("blend", 1.0),
                                    ("bin", 4.0), ("project", None)]):
        rec.records.append(profiling.SpanRecord(
            name, i + 1, None, 1, i, i + 1, stream_ms=ms))
    rec.counts["bin.pairs"] = 9
    run = _Run(events=[("k", 0.0, 1.0)], steps=3, program_spans=rec)
    assert bench_spans.stage_ms(run, "bin") == 2.0
    assert bench_spans.stage_ms(run, "blend") == 1.0 / 3
    assert bench_spans.stage_ms(run, "project") is None
    assert bench_spans.per_step(run, "bin.pairs") == 3.0
    assert bench_spans.per_step(run, "other") is None


@pytest.mark.gpu
def test_span_and_kernel_share_the_profiler_clock():
    """On the card: a span around ``torch.cuda._sleep`` and a synchronize
    holds the profiler's interval of that kernel within its host interval,
    and its stream time is the kernel's duration within 5%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            profiling.collect() as rec:
        with profiling.span("sleep", dev):
            torch.cuda._sleep(40_000_000)
            torch.cuda.synchronize()
    (s,) = rec.resolve()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    k = max(kernels, key=lambda e: e.duration_ns())
    k0, k1 = k.start_ns(), k.start_ns() + k.duration_ns()
    assert s.start_ns <= k0 and k1 <= s.end_ns, (s.start_ns, k0, k1,
                                                  s.end_ns)
    dur_ms = k.duration_ns() / 1e6
    assert dur_ms > 5.0
    assert abs(s.stream_ms - dur_ms) <= 0.05 * dur_ms, (s.stream_ms, dur_ms)
