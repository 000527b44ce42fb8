"""One run of one cell: set-up, the measured window, and the comparison
with the reference once the window has closed.

Two loops, chosen by the mix's ``loop``:

* ``train``: one training-step object (the scene's leaves, the optimizer,
  the autotuned config) built in set-up and driven from the seed through
  its first steps there, then handed to the window.  A step renders pose
  i of the orbit with the program's ``render``, takes loss
  sum(image**2), runs backward and an SGD step with momentum.  The window
  runs closed-loop steps for ``seconds``; ``train_step_ms`` is its time
  over its steps.
* ``view``: a closed-loop orbit, one ``render`` under ``no_grad`` per
  pose, each frame ending at a synchronize with its image on the device;
  frame i takes pose i * stride mod P, a stride prime to P that spreads
  any run of frames evenly over the orbit, so the window's poses do not
  depend on where it ends;
  ``frame_ms_p95`` is the 95th percentile of the frames' times, each read
  from CUDA events around the frame.

The scene, the reference that judges the run and the work counts of its
roofline come from ``ref``, the reference module the configuration names
(``cells.Spec.reference``); the program's render settings from the
configuration's ``"render"``.

``fault`` plants a fault of the timed path for the tests and the proof
runs (``FAULTS``); ``control`` puts the reference computed in TF32, the
next precision below the configuration's float32 with TF32 off, in the
program's place.  Neither is used by the benchmark's own runs.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from benchmark import judge, trace, traffic
from gaussiansplattingviewer_tpu_torch.config import RenderConfig
from gaussiansplattingviewer_tpu_torch.models.gaussians import GaussianData
from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
from gaussiansplattingviewer_tpu_torch.ops.render import render

FAULTS = {
    "train": ("state_unchanged", "half_batch"),
    "view": ("answer_altered",),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counted_syncs(fn, dev):
    """Run ``fn`` once: (its result, the synchronizing CUDA calls it made
    by torch's sync debug mode; None off the card)."""
    if dev.type != "cuda":
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


class SGD:
    """SGD with momentum and dampening over a list of leaves, with
    ``torch.optim.SGD``'s update (the buffer is the first gradient at step
    1, then b = mu b + (1 - d) g; p -= lr b) in foreach calls."""

    def __init__(self, params, lrs, momentum: float, dampening: float):
        self.params, self.lrs = params, lrs
        self.momentum, self.dampening = momentum, dampening
        self.buf = None

    def buffers(self):
        """The momentum buffers (zeros before the first step)."""
        if self.buf is None:
            return [torch.zeros_like(p.detach()) for p in self.params]
        return self.buf

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        if self.buf is None:
            self.buf = [g.clone() for g in grads]
        else:
            torch._foreach_mul_(self.buf, self.momentum)
            torch._foreach_add_(self.buf, grads, alpha=1 - self.dampening)
        for p, b, lr in zip(self.params, self.buf, self.lrs):
            p.sub_(b, alpha=lr)


class Run:
    """What a run measured and produced, for the metrics and the judge."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(config: dict, ref, mix: dict, limits: dict, seed: int,
        seconds: float, traced: bool, device, t_start: float,
        fault: str | None = None) -> Run:
    """Set up, measure for ``seconds``, then judge against the reference
    module ``ref``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    width, height = config["width"], config["height"]
    cfg = RenderConfig(width=width, height=height, **config["render"])
    scene0 = ref.make_scene(config, seed, dev)
    poses = traffic.orbit(config, mix["poses"], dev)
    tune = traffic.spread(mix["tune_poses"], len(poses))
    _sync(dev)
    t = time.perf_counter()
    cfg = autotune(GaussianData(**scene0), *zip(*(poses[i] for i in tune)),
                   cfg, probe=True, fused=None)
    autotune_s = time.perf_counter() - t
    phases = {"start": t - t_start, "autotune": autotune_s}

    def frame(view, proj, cam, scene):
        img = render(scene, view, proj, cam, cfg, device=dev)
        if fault == "answer_altered":
            img = img.clone()
            img[:16, :16] += 0.25
        return img

    args = dict(config=config, ref=ref, mix=mix, seed=seed,
                seconds=seconds, traced=traced, dev=dev, t_start=t_start,
                poses=poses, frame=frame, fault=fault, scene0=scene0,
                phases=phases)
    out = _train(**args) if mix["loop"] == "train" else _view(**args)
    out.work = ref.WORK
    out.autotune_s = autotune_s
    out.phases = phases
    out.route = ("fused K %d" % cfg.prefix_rows) if cfg.fused_grad \
        else "classic"
    out.n_splats = int(scene0[ref.LEAVES[0]].shape[0])
    out.correct, out.checks = judge.verdict(out.checks, limits)
    if out.kind == "view":
        out.failed = sum(g > limits["img_rms"] or g != g for g in out.gaps)
    elif not out.correct:
        out.failed = mix["compared_steps"]
    return out


def _window(step, seconds, traced, dev):
    """Closed-loop calls of ``step(i)`` for ``seconds``: (calls, seconds
    from a synchronize to a synchronize, the device events if traced)."""
    with trace.device_trace(traced) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            step(n)
            n += 1
        _sync(dev)
        dt = time.perf_counter() - t0
    events = trace.device_events(prof) if traced else None
    return n, dt, events


def _train(config, ref, mix, seed, seconds, traced, dev, t_start, poses,
           frame, fault, scene0, phases):
    leaves = ref.LEAVES
    params = {k: a.clone().requires_grad_(True) for k, a in scene0.items()}
    scene = GaussianData(**params)
    opt = SGD([params[k] for k in leaves], [mix["lr"][k] for k in leaves],
              mix["momentum"], mix["dampening"])
    start = seed % len(poses)
    height = config["height"]

    def pose(i):
        return poses[(start + i) * mix["stride"] % len(poses)]

    def step(i):
        view, proj, cam = pose(i)
        img = frame(view, proj, cam, scene)
        if fault == "half_batch":
            loss = 2.0 * (img[: height // 2] ** 2).sum()
        else:
            loss = (img * img).sum()
        loss.backward()
        if fault != "state_unchanged":
            opt.step()
        for p in params.values():
            p.grad = None
        return img, loss

    first = mix["compared_steps"]
    p0 = scene0
    losses, grad, image = [], None, None
    for i in range(first):
        img, loss = step(i)
        losses.append(loss.detach())
        phases[f"step {i}"] = time.perf_counter() - t_start
        if i == 0:
            image = img.detach().clone()
            grad = {k: b.clone() for k, b in zip(leaves, opt.buffers())}
    change = {k: params[k].detach() - p0[k] for k in leaves}
    _, syncs = _counted_syncs(lambda: step(first), dev)
    done = first + 1
    for i in range(done, done + mix["warmup_steps"]):
        step(i)
    done += mix["warmup_steps"]
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    phases["warm-up"] = setup_s

    n, dt, events = _window(lambda i: step(done + i), seconds, traced, dev)
    t_ref = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "change": change, "image": image}
    del scene, opt, params, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_poses = [pose(i) for i in range(first)]
    r_losses, r_grad, r_final, r_image, stats = ref.train_steps(
        p0, ref_poses, mix, config["width"], height)
    expected = {"losses": r_losses, "grad": r_grad,
                "change": {k: r_final[k] - p0[k] for k in leaves},
                "image": r_image}
    checks, leaf_gaps = judge.train_checks(prog, expected, leaves)
    phases["reference"] = time.perf_counter() - t_ref
    return Run(kind="train", setup_s=setup_s, steps=n, window_s=dt,
               events=events, host_syncs=syncs, memory_peak_bytes=peak,
               needed=_mean_needed(stats), checks=checks,
               leaf_gaps=leaf_gaps, attempted=n + done, failed=0,
               metrics={"train_step_ms": dt / n * 1e3 if n else None})


def _view(config, ref, mix, seed, seconds, traced, dev, t_start, poses,
          frame, fault, scene0, phases):
    gd = GaussianData(**scene0)
    # the compared frames: a uniform sample of the window's frames drawn
    # from the seed (reservoir sampling, so only the sample is held)
    rng = np.random.default_rng(seed % (1 << 63))
    slots = mix["compared_frames"]
    kept = []
    cuda = dev.type == "cuda"
    times = []

    def step(i):
        view, proj, cam = poses[i * mix["stride"] % len(poses)]
        if cuda:
            ev = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            ev[0].record()
        else:
            t = time.perf_counter()
        with torch.no_grad():
            img = frame(view, proj, cam, gd)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize(dev)
            times.append(ev)
        else:
            times.append(time.perf_counter() - t)
        if i < slots:
            kept.append((i, img))
        else:
            j = int(rng.integers(0, i + 1))
            if j < slots:
                kept[j] = (i, img)

    with torch.no_grad():
        for i in traffic.spread(mix["warmup_frames"], len(poses)):
            frame(*poses[i], gd)
        _, syncs = _counted_syncs(lambda: frame(*poses[0], gd), dev)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    phases["warm-up"] = setup_s

    n, dt, events = _window(step, seconds, traced, dev)
    t_ref = time.perf_counter()
    frame_ms = [e[0].elapsed_time(e[1]) for e in times] if cuda \
        else [t * 1e3 for t in times]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del gd

    gaps, needed = [], []
    with torch.no_grad():
        for i, img in kept:
            view, proj, cam = poses[i * mix["stride"] % len(poses)]
            expected, _, st = ref.render(scene0, view, proj, cam,
                                         config["width"], config["height"])
            gaps.append(judge.img_rms(img, expected))
            needed.append(st)
            del expected
    checks = {"img_rms": max(gaps) if gaps else float("nan")}
    phases["reference"] = time.perf_counter() - t_ref
    return Run(kind="view", setup_s=setup_s, steps=n, window_s=dt,
               events=events, host_syncs=syncs, memory_peak_bytes=peak,
               needed=_mean_needed(needed), checks=checks, gaps=gaps,
               attempted=n, failed=0,
               metrics={"frame_ms_p95": p95(frame_ms) if n else None})


def _mean_needed(stats: list[dict]) -> dict | None:
    if not stats:
        return None
    return {k: sum(s[k] for s in stats) / len(stats) for k in stats[0]}


def control(config: dict, ref, mix: dict, limits: dict, seed: int,
            device) -> Run:
    """The control: the reference module ``ref`` computed in TF32 in the
    program's place, on the inputs a run of ``seed`` makes (its first
    training steps, or as many frames as a run compares, at poses drawn
    from the seed), judged as a run is judged."""
    dev = torch.device(device)
    scene = ref.make_scene(config, seed, dev)
    poses = traffic.orbit(config, mix["poses"], dev)
    width, height = config["width"], config["height"]
    if mix["loop"] == "train":
        start = seed % len(poses)
        steps = [poses[(start + i) * mix["stride"] % len(poses)]
                 for i in range(mix["compared_steps"])]
        sides = []
        for tf32 in (True, False):
            losses, grad, final, image, _ = ref.train_steps(
                scene, steps, mix, width, height, tf32=tf32)
            sides.append({"losses": losses, "grad": grad, "image": image,
                          "change": {k: final[k] - scene[k]
                                     for k in ref.LEAVES}})
            del final
        checks, leaf_gaps = judge.train_checks(sides[0], sides[1],
                                               ref.LEAVES)
    else:
        rng = np.random.default_rng(seed % (1 << 63))
        gaps = []
        for i in rng.choice(len(poses), mix["compared_frames"],
                            replace=False).tolist():
            low, _, _ = ref.render(scene, *poses[i], width, height,
                                   tf32=True)
            expected, _, _ = ref.render(scene, *poses[i], width, height)
            gaps.append(judge.img_rms(low, expected))
        checks, leaf_gaps = {"img_rms": max(gaps)}, None
    correct, table = judge.verdict(checks, limits)
    return Run(kind=mix["loop"], correct=correct, checks=table,
               leaf_gaps=leaf_gaps)
