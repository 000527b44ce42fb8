"""BENCHMARK.json keeps to the benchmark contract's shapes: names, units,
keys, counts and bounds."""

from __future__ import annotations

import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(d["command"]) <= 32 and all(_line(w) for w in
                                                d["command"])
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len((spec.root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(spec):
    d = spec.data
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in d[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in d["paths"]))
    files = [c["file"] for c in d["configs"]]
    assert len(files) == len(set(files))


def test_cells(spec):
    d = spec.data
    configs = {c["name"] for c in d["configs"]}
    assert 1 <= len(d["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in d["workloads"]}
    assert len(pairs) == len(d["workloads"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert {w["config"] for w in d["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in d["workloads"])
    assert four <= max(1, len(d["workloads"]) // 4)


def test_metrics(spec):
    d = spec.data
    e2e = {m["name"]: m for m in d["end_to_end"]}
    cells = {w["name"] for w in d["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        reported = [m for m in d["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(c in m.get("workloads", cells) for m in d["per_layer"])


def test_check_fits_the_time_limit(spec):
    d = spec.data
    per_cell = 14 * (d["run_seconds"] + 60) + 2 * 90
    assert 2 * (d["run_seconds"] + 60) + 24 * per_cell + 1200 <= 43200


def test_files_stay_under_paths(spec):
    root = spec.root
    for p in spec.data["paths"]:
        assert (root / p).is_dir()
    for c in spec.data["configs"]:
        assert (root / c["file"]).is_file()
    for path in Path(spec.dir).rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.dir).as_posix()
            assert PATH.match(rel), rel
