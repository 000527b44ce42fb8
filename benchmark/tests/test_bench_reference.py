"""The plain reference agrees with the program at a toy size on the CPU
(the program's plain versions of its kernels there), on the classic and
the fused path: the image, the loss and, with the gradient fold in
float32, every leaf's gradient element by element."""

from __future__ import annotations

import pytest
import torch

from benchmark import traffic
from benchmark.reference import splat
from benchmark.scene import LEAVES, make_scene
from benchmark.tests.conftest import toy


@pytest.mark.parametrize("dense", [False, True], ids=["classic", "fused"])
def test_reference_matches_the_program(spec, dense):
    from gaussiansplattingviewer_tpu_torch.config import RenderConfig
    from gaussiansplattingviewer_tpu_torch.models.gaussians import (
        GaussianData,
    )
    from gaussiansplattingviewer_tpu_torch.ops.autotune import autotune
    from gaussiansplattingviewer_tpu_torch.ops.render import render

    config = toy(spec.config("garden"), dense)
    w, h = config["width"], config["height"]
    scene = make_scene(config, 2**33 + 1, "cpu")
    poses = traffic.orbit(config, 8, "cpu")
    cfg = autotune(GaussianData(**scene), *zip(*poses[:4]),
                   RenderConfig(width=w, height=h), probe=True, fused=None)
    assert cfg.fused_grad == dense
    # the default fold rounds each table row's gradient to bf16, which
    # the reference does not: compare gradients with the fold in float32
    cfg = cfg.with_(grad_fold_bf16=False)

    leaves = {k: a.clone().requires_grad_(True) for k, a in scene.items()}
    img = render(GaussianData(**leaves), *poses[1], cfg, device="cpu")
    (img * img).sum().backward()

    ref_leaves = {k: a.clone().requires_grad_(True)
                  for k, a in scene.items()}
    ref, loss, stats = splat.render(ref_leaves, *poses[1], w, h, grad=True)
    assert stats["fragments"] > 0 and stats["rows"] > 0
    img = img.detach()
    assert float((img - ref).norm() / ref.norm()) < 1e-5
    assert abs(float((img * img).sum()) - float(loss)) < 1e-5 * float(loss)
    for k in LEAVES:
        g, r = leaves[k].grad, ref_leaves[k].grad
        assert float((g - r).norm() / r.norm()) < 1e-3, k

