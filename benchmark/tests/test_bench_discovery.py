"""The harness finds every part of a cell by name, and a new
configuration, mix, limits file or per-layer metric is picked up from new
files and entries alone."""

from __future__ import annotations

import json
import shutil

from benchmark import cells


def test_every_cell_finds_its_parts(spec):
    for w in spec.data["workloads"]:
        config = spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        limits = spec.limits(w["name"])
        assert config["n_splats"] > 0 and mix["loop"] in ("train", "view")
        assert limits and all(v > 0 for v in limits.values())
        assert spec.end_to_end(w["name"])
        for m in spec.per_layer(w["name"]):
            assert callable(spec.reader(m["name"]))


def test_new_files_are_picked_up_with_no_edit(spec, tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.dir, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    data = json.loads(json.dumps(spec.data))
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {**spec.config("garden"), "name": "tiny", "n_splats": 64}))
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
    cell = found.cell("tiny-still")
    assert found.config(cell["config"])["n_splats"] == 64
    assert found.traffic(cell["traffic"])["poses"] == 1
    assert found.limits("tiny-still") == {"img_rms": 1e-3}
    assert [m["name"] for m in found.per_layer("tiny-still")] == [
        "frames_seen.view"]

    class Run:
        steps = 7

    assert found.reader("frames_seen.view")(Run) == 7.0
    # a dotted metric falls back to the reader of its base name
    assert found.reader("device_ms.view") is not None


def test_kept_files_match_the_cells_format(spec):
    # a configuration or limits file kept for a cell that waits outside
    # BENCHMARK.json (PERF.md, Open questions) stays loadable as it is
    keys = set(spec.config("garden"))
    for path in (spec.dir / "configs").glob("*.json"):
        assert set(json.loads(path.read_text())) == keys, path.name
    train = set(spec.limits("garden-train"))
    for path in (spec.dir / "limits").glob("*-train.json"):
        assert set(json.loads(path.read_text())) == train, path.name
