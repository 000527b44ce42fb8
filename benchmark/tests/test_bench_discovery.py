"""The harness finds every part of a cell by name, and a new
configuration, reference, render setting, mix, limits file or per-layer
metric is picked up from new files and entries alone."""

from __future__ import annotations

import json
import shutil
import time

import pytest

from benchmark import cell, cells
from benchmark.tests.conftest import toy

CONTRACT = ("LEAVES", "make_scene", "render", "train_steps", "WORK")

# a reference module of a test's own: 3DGS's, counting the calls the judge
# makes of it
STUB = """from benchmark.reference import splat
from benchmark.reference.splat import LEAVES, WORK, make_scene

calls = []


def render(*args, **kw):
    calls.append("render")
    return splat.render(*args, **kw)


def train_steps(*args, **kw):
    calls.append("train_steps")
    return splat.train_steps(*args, **kw)
"""


def test_every_cell_finds_its_parts(spec):
    for w in spec.data["workloads"]:
        config = spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        limits = spec.limits(w["name"])
        assert config["n_splats"] > 0 and mix["loop"] in ("train", "view")
        ref = spec.reference(config)
        assert all(hasattr(ref, name) for name in CONTRACT)
        assert limits and all(v > 0 for v in limits.values())
        assert spec.end_to_end(w["name"])
        for m in spec.per_layer(w["name"]):
            assert callable(spec.reader(m["name"]))


def test_new_files_are_picked_up_with_no_edit(spec, tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.dir, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    data = json.loads(json.dumps(spec.data))
    tiny = {**toy(spec.config("garden")), "name": "tiny",
            "reference": "stub",
            "render": {"tile_size": 8, "grad_fold_bf16": False}}
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny))
    (bench / "reference" / "stub.py").write_text(STUB)
    (bench / "traffic" / "still.json").write_text(json.dumps(
        {**spec.traffic("view"), "poses": 1}))
    (bench / "limits" / "tiny-still.json").write_text('{"img_rms": 1e-3}')
    (bench / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    data["configs"].append({"name": "tiny", "source": "https://example.org",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "tiny-still", "config": "tiny",
                              "traffic": "still", "chips": 1, "why": "test"})
    data["per_layer"].append({"name": "frames_seen.view", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "frame_ms_p95",
                              "workloads": ["tiny-still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    found = cells.Spec(tmp_path, bench)
    w = found.cell("tiny-still")
    config = found.config(w["config"])
    assert config["n_splats"] == tiny["n_splats"]
    assert found.traffic(w["traffic"])["poses"] == 1
    assert found.limits("tiny-still") == {"img_rms": 1e-3}
    assert [m["name"] for m in found.per_layer("tiny-still")] == [
        "frames_seen.view"]

    class Run:
        steps = 7

    assert found.reader("frames_seen.view")(Run) == 7.0
    # a dotted metric falls back to the reader of its base name
    assert found.reader("device_ms.view") is not None

    # a run of the new cell renders at the configuration's tile size and
    # is judged by the configuration's reference
    stub = found.reference(config)
    assert all(hasattr(stub, name) for name in CONTRACT)
    tiles = []

    def spy(scene, view, proj, cam, cfg, **kw):
        tiles.append(cfg.tile_size)
        return render(scene, view, proj, cam, cfg, **kw)

    render = cell.render
    monkeypatch.setattr(cell, "render", spy)
    out = cell.run(config, stub, found.traffic(w["traffic"]),
                   found.limits(w["name"]), 2**31 + 11, 0.3, False, "cpu",
                   time.perf_counter())
    assert tiles and set(tiles) == {8}
    assert stub.calls == ["render"] * len(out.gaps) and out.gaps
    assert out.work is stub.WORK
    assert out.checks["img_rms"]["value"] == max(out.gaps)


def test_an_unknown_render_field_fails_setup(spec):
    config = {**toy(spec.config("garden")),
              "render": {"grad_fold_bf16": False, "tile_szie": 8}}
    with pytest.raises(TypeError, match="tile_szie"):
        cell.run(config, spec.reference(config), spec.traffic("view"),
                 spec.limits("garden-view"), 3, 0.1, False, "cpu",
                 time.perf_counter())


def test_kept_files_match_the_cells_format(spec):
    # a configuration or limits file kept for a cell that waits outside
    # BENCHMARK.json (PERF.md, Open questions) stays loadable as it is
    keys = set(spec.config("garden"))
    for path in (spec.dir / "configs").glob("*.json"):
        assert set(json.loads(path.read_text())) == keys, path.name
    train = set(spec.limits("garden-train"))
    for path in (spec.dir / "limits").glob("*-train.json"):
        assert set(json.loads(path.read_text())) == train, path.name
