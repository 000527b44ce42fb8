"""PyTorch port: the PLY round trip (``eval/ply_roundtrip.py``, the port of
``scripts/ply_roundtrip_tpu.py``) and the scaling harness
(``eval/scaling.py``, the port of ``scripts/scaling.py``) on the CPU at a
tiny size.

The round trip passes its gates, refuses to fall back to numpy, and the
file it writes loads bit-equal through JAX's ``load_ply``.  The scaling
harness's bands equal ``render()``'s rows within 1e-5, its efficiency
formulas give the JAX script's values on the JAX runs' own shard times
(SCALING_TPU.json, SCALING.json), and its JSON carries no bandwidth
constant.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.models import load_ply as jax_load_ply
from gaussiansplattingviewer_tpu_torch.eval import ply_roundtrip, scaling
from gaussiansplattingviewer_tpu_torch.models import load_ply

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "rot", "scale", "opacity", "sh")
SMALL = ["--n-splats", "3000", "--width", "96", "--height", "64",
         "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test, restored after it: the harnesses'
    many small ops under the suite's parallel workers otherwise spend 30
    to 60 times as long waiting on the thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ply_roundtrip_passes_its_gates(tmp_path, capsys):
    out = tmp_path / "ply.json"
    assert ply_roundtrip.main(SMALL + ["--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["pass"] is True and res["card"] == "cpu"
    assert res["n_splats"] == 3000
    assert set(res["field_rel_max"]) == set(FIELDS)
    assert max(res["field_rel_max"].values()) < ply_roundtrip.FIELD_REL_TOL
    assert res["img_max_abs_diff"] < ply_roundtrip.IMG_MAX_TOL
    assert res["img_p999_abs_diff"] < ply_roundtrip.IMG_P999_TOL
    assert res["fused_mem"] == res["fused_ply"]
    # the header and 62 float columns per splat
    assert res["file_bytes"] > 3000 * 62 * 4
    assert "pass=True" in capsys.readouterr().out


def test_ply_roundtrip_file_loads_bit_equal_through_jax(tmp_path):
    path = tmp_path / "point_cloud.ply"
    res = ply_roundtrip.roundtrip(3000, 96, 64, path, "cpu")
    assert res["pass"] and res["file_bytes"] == path.stat().st_size
    ours, bbox, center = load_ply(path)
    theirs, j_bbox, j_center = jax_load_ply(path, use_native=False)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(bbox, np.asarray(j_bbox))
    np.testing.assert_array_equal(center, np.asarray(j_center))


def test_ply_roundtrip_needs_the_native_reader(tmp_path, monkeypatch):
    monkeypatch.setattr(ply_roundtrip, "_load_ply_native",
                        lambda path: None)
    with pytest.raises(RuntimeError, match="native PLY reader"):
        ply_roundtrip.roundtrip(500, 32, 32, tmp_path / "pc.ply", "cpu")


def _keys(obj):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield k
            yield from _keys(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _keys(v)


def test_scaling_bands_match_render(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    assert scaling.main(SMALL + ["--iters", "1", "--out", str(out)]) == 0
    text = out.read_text()
    res = json.loads(text)
    assert res["config"]["card"] == "cpu"
    runs = {(r["n_dev"], r["assignment"]): r for r in res["runs"]}
    kinds = ("contiguous", "interleaved", "precull-contiguous",
             "precull-interleaved")
    want = {(1, "contiguous")} | {(n, k) for n in (2, 4, 8) for k in kinds}
    want |= {(n, f"exchange-{k}") for n in (2, 4, 8)
             for k in ("contiguous", "interleaved")}
    assert set(runs) == want
    for (n_dev, _), r in runs.items():
        assert len(r["shard_ms"]) == n_dev and min(r["shard_ms"]) > 0
        # at this size no band outgrows its budget
        assert r["dropped"] == 0 and r["max_abs_vs_render"] <= 1e-5, r
        assert 0 < r["balance_eff"] <= 1.0
    assert runs[(1, "contiguous")]["scaling_eff"] == 1.0
    for n in (2, 4, 8):
        r = runs[(n, "exchange-contiguous")]
        assert r["max_send_bytes"] > 0 and r["all_to_all_ms"] is None
    comm = res["train_comm"]
    assert comm["ring_allreduce_ms"] is None and comm["grad_bytes"] > 0
    # no link rate, assumed or modeled (the JAX script's ici_gbps_assumed,
    # modeled_ici_ms, dcn_gbps_assumed, ring_allreduce_ms_ici, ...)
    assert "gbps" not in text.lower()
    assert not [k for k in _keys(res) if "ici" in k.split("_")
                or "dcn" in k or "modeled" in k]
    assert "SCALING_EFF" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["SCALING_TPU.json", "SCALING.json"])
def test_efficiencies_give_the_jax_values(name):
    """The JAX script's replicated rows, recomputed from their own shard
    times (rounded to 0.01 ms, hence the last digit's tolerance)."""
    jax_res = json.loads((ROOT / name).read_text())
    rows = [r for r in jax_res["runs"]
            if not r["assignment"].startswith("exchange")]
    t1 = rows[0]["shard_ms"][0] / 1e3
    assert rows[0]["n_dev"] == 1
    assert len(rows) == 13
    for r in rows:
        got = scaling.efficiencies([t / 1e3 for t in r["shard_ms"]], t1,
                                   jax_res["config"]["num_tiles"])
        assert got["projected_ms_per_frame"] == r["projected_ms_per_frame"]
        for k in ("scaling_eff", "balance", "balance_eff"):
            assert abs(got[k] - r[k]) <= 1.5e-3, (r, k, got[k])
        assert got["projected_tiles_per_s"] == pytest.approx(
            r["projected_tiles_per_s"], rel=2e-4)
