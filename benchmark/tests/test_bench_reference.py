"""Each configured reference agrees with the program at a toy size on the
CPU (the program's plain versions of its kernels there), on the classic
and the fused path: the image, the loss and, with the gradient fold in
float32, every leaf's gradient element by element.  The reference is the
module a configuration of BENCHMARK.json names, so a configuration's new
reference gets this comparison from its entry alone."""

from __future__ import annotations

import json

import pytest

from benchmark import traffic
from benchmark.tests.conftest import ROOT, toy


def _configured_references() -> dict:
    """{reference name: the first configuration of BENCHMARK.json that
    names it}."""
    out = {}
    for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]:
        name = json.loads((ROOT / c["file"]).read_text())["reference"]
        out.setdefault(name, c["name"])
    return out


REFERENCES = _configured_references()


@pytest.mark.parametrize("dense", [False, True], ids=["classic", "fused"])
@pytest.mark.parametrize("reference", sorted(REFERENCES))
def test_reference_matches_the_program(spec, reference, dense):
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.models.gaussians import (
        GaussianData,
    )
    from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
    from gaussiansplattingviewer_tpu_torch.ops.render import render

    config = toy(spec.config(REFERENCES[reference]), dense)
    ref = spec.reference(config)
    w, h = config["width"], config["height"]
    scene = ref.make_scene(config, 2**33 + 1, "cpu")
    poses = traffic.orbit(config, 8, "cpu")
    cfg = autotune(GaussianData(**scene), *zip(*poses[:4]),
                   RenderConfig(width=w, height=h, **config["render"]),
                   probe=True, fused=None)
    assert cfg.fused_grad == dense
    # the default fold rounds each table row's gradient to bf16, which
    # the reference does not: compare gradients with the fold in float32
    cfg = cfg.with_(grad_fold_bf16=False)

    leaves = {k: a.clone().requires_grad_(True) for k, a in scene.items()}
    img = render(GaussianData(**leaves), *poses[1], cfg, device="cpu")
    (img * img).sum().backward()

    ref_leaves = {k: a.clone().requires_grad_(True)
                  for k, a in scene.items()}
    expected, loss, stats = ref.render(ref_leaves, *poses[1], w, h,
                                       grad=True)
    assert stats["fragments"] > 0 and stats["rows"] > 0
    img = img.detach()
    assert float((img - expected).norm() / expected.norm()) < 1e-5
    assert abs(float((img * img).sum()) - float(loss)) < 1e-5 * float(loss)
    for k in ref.LEAVES:
        g, r = leaves[k].grad, ref_leaves[k].grad
        assert float((g - r).norm() / r.norm()) < 1e-3, k
