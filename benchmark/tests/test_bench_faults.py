"""A whole run of each cell's loop on the CPU at a toy size, past the
harness's look for a card: sound, it comes out correct; with its timed
path broken underneath by each fault the cell can have, ``correct`` comes
out false, and so does the control (the reference in TF32 in the
program's place).  The result line keeps the contract's keys, the compared
numbers last."""

from __future__ import annotations

import time

import pytest

from benchmark import cell, run
from benchmark.tests.conftest import toy

CASES = [(w, f) for w in ("garden-train", "garden-view")
         for f in (None,) + cell.FAULTS["view" if w.endswith("view")
                                         else "train"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_run_judges_the_timed_path(spec, workload, fault):
    w = spec.cell(workload)
    config = spec.config(w["config"])
    out = cell.run(toy(config), spec.reference(config),
                   spec.traffic(w["traffic"]), spec.limits(workload),
                   2**32 + 99, 0.5, False, "cpu", time.perf_counter(),
                   fault=fault)
    assert out.correct is (fault is None), out.checks
    assert out.steps > 0 and out.setup_s > 0
    out.trace = None
    line = run.result_line(spec, workload, out, False,
                           {"platform": "cpu", "count": 1})
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert "setup_s" in line["metrics"]
    assert (line["failed"] == 0) is (fault is None)


@pytest.mark.parametrize("workload", ["garden-train", "garden-view"])
def test_control_comes_out_not_correct(spec, workload):
    w = spec.cell(workload)
    config = spec.config(w["config"])
    out = cell.control(toy(config), spec.reference(config),
                       spec.traffic(w["traffic"]), spec.limits(workload),
                       2**31 + 5, "cpu")
    assert not out.correct, out.checks


def test_fused_path_is_judged(spec):
    w = spec.cell("garden-train")
    config = spec.config("garden")
    out = cell.run(toy(config, dense=True), spec.reference(config),
                   spec.traffic("train"), spec.limits("garden-train"), 7,
                   0.5, False, "cpu", time.perf_counter())
    assert out.route.startswith("fused") and out.correct, out.checks
    assert w["config"] == "garden"
