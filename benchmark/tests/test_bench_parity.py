"""What a configuration's reference module makes and counts is what the
harness made and counted before the 3DGS parts moved into
``reference/splat.py``: the garden scene bit for bit, and the roofline's
bounds and FLOPs to the last digit (digests and values recorded from the
harness as it was)."""

from __future__ import annotations

import hashlib

import pytest

from benchmark import roofline
from benchmark.tests.conftest import toy

SEED = 2**33 + 1
SCENE_SHA256 = {
    False: "7b3c6f4454c6648ed92c66caf790a2035f04577e80ec59f5f002e7f8b2785196",
    True: "4b815fd589be4e73656411cba1bc0bb4cb3605df09df57bdb920a759b17348b4",
}
NEEDED = {"rows": 1234567.25, "fragments": 98765432.5, "tiles": 8160}
# {train: (blend_bound_s, step_flops of 5,800,960 splats)}
ROOFLINE = {
    False: (4.4223327985074626e-05, 5225337375.0),
    True: (0.00015183342608208954, 16959962747.5),
}


@pytest.mark.parametrize("dense", [False, True], ids=["toy", "dense"])
def test_garden_scene_is_bit_equal(spec, dense):
    config = spec.config("garden")
    ref = spec.reference(config)
    scene = ref.make_scene(toy(config, dense), SEED, "cpu")
    assert list(scene) == list(ref.LEAVES)
    digest = hashlib.sha256()
    for k in ref.LEAVES:
        digest.update(scene[k].contiguous().numpy().tobytes())
    assert digest.hexdigest() == SCENE_SHA256[dense]


@pytest.mark.parametrize("train", [False, True], ids=["view", "train"])
def test_roofline_reads_the_same(spec, train):
    work = spec.reference(spec.config("garden")).WORK
    bound, flops = ROOFLINE[train]
    assert roofline.blend_bound_s(NEEDED, train, work) == bound
    assert roofline.step_flops(5800960, NEEDED, train, work) == flops
