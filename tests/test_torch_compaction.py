"""PyTorch port: budgeted compaction (ops/compaction.py) against the JAX
package's: the same rows, ``kept`` and ``dropped`` (a case with dropped >
0 included), and the gradient of a weighted sum of the compact rows within
1e-6 (rows past the budget get none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiansplattingviewer_tpu.ops import compaction as jc
from gaussiansplattingviewer_tpu_torch.ops import compaction as pc
from torch_port_util import SPLAT_FIELDS, both_splats, synthetic_splats

FLOAT_FIELDS = ("mean2d", "depth", "conic", "radius", "color", "opacity")


def _mask(n, frac, seed):
    return np.random.default_rng(seed).uniform(size=n) < frac


@pytest.mark.parametrize("n,frac,budget", [
    (6000, 0.3, 4096),   # every selected row fits
    (6000, 0.8, 4096),   # dropped > 0
    (300, 0.5, 512),     # budget above n: clipped to n
    (500, 0.0, 128),     # nothing selected
])
def test_compact_by_mask_matches_jax(n, frac, budget):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    mask = _mask(n, frac, seed=n + 1)
    (jx, jids), jkept, jdrop = jc.compact_by_mask(
        (jnp.asarray(x), jnp.asarray(ids)), jnp.asarray(mask), budget)
    xt = torch.from_numpy(x).requires_grad_(True)
    (px, pids), pkept, pdrop = pc.compact_by_mask(
        (xt, torch.from_numpy(ids)), torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(px.detach().numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(pkept.numpy(), np.asarray(jkept))
    assert int(pdrop) == int(jdrop) == max(int(mask.sum()) - min(budget, n),
                                           0)
    if frac == 0.8:
        assert int(pdrop) > 0

    w = rng.normal(size=np.asarray(jx).shape).astype(np.float32)
    g_jax = jax.grad(lambda a: jnp.sum(jc.compact_by_mask(
        (a,), jnp.asarray(mask), budget)[0][0] * w))(jnp.asarray(x))
    (px * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_jax),
                               atol=1e-6)
    # rows past the budget (or unselected past it) get no gradient
    rank = np.argsort(~mask, kind="stable")
    np.testing.assert_array_equal(xt.grad.numpy()[rank[budget:]], 0.0)


def test_compact_splats_matches_jax():
    arrays = synthetic_splats(5000, 160, 96, seed=4)
    arrays["valid"][::7] = False
    mask = _mask(5000, 0.9, seed=5)
    j_s, p_s = both_splats(arrays)
    for f in FLOAT_FIELDS:
        getattr(p_s, f).requires_grad_(True)
    jout, jkept, jdrop = jc.compact_splats(j_s, jnp.asarray(mask), 4096)
    pout, pkept, pdrop = pc.compact_splats(p_s, torch.from_numpy(mask),
                                           4096)
    assert int(pdrop) == int(jdrop) > 0
    np.testing.assert_array_equal(pkept.numpy(), np.asarray(jkept))
    for f in SPLAT_FIELDS:
        np.testing.assert_array_equal(getattr(pout, f).detach().numpy(),
                                      np.asarray(getattr(jout, f)), f)

    rng = np.random.default_rng(6)
    ws = {f: rng.normal(size=np.asarray(getattr(jout, f)).shape).astype(
        np.float32) for f in FLOAT_FIELDS}

    def jloss(*fields):
        s = j_s.__class__(**dict(zip(FLOAT_FIELDS, fields)),
                          valid=j_s.valid)
        out = jc.compact_splats(s, jnp.asarray(mask), 4096)[0]
        return sum(jnp.sum(getattr(out, f) * ws[f]) for f in FLOAT_FIELDS)

    g_jax = jax.grad(jloss, argnums=tuple(range(6)))(
        *(getattr(j_s, f) for f in FLOAT_FIELDS))
    sum((getattr(pout, f) * torch.from_numpy(ws[f])).sum()
        for f in FLOAT_FIELDS).backward()
    for f, g in zip(FLOAT_FIELDS, g_jax):
        np.testing.assert_allclose(getattr(p_s, f).grad.numpy(),
                                   np.asarray(g), atol=1e-6, err_msg=f)


def test_pack_unpack_round_trip():
    arrays = synthetic_splats(200, 96, 64, seed=2)
    arrays["valid"][::3] = False
    _, p_s = both_splats(arrays)
    back = pc.unpack_splats(*pc.pack_splats(p_s))
    for f in SPLAT_FIELDS:
        want = getattr(p_s, f)
        if f == "opacity":  # pack zeroes the opacity of invalid splats
            want = torch.where(p_s.valid, want, torch.zeros_like(want))
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      want.numpy(), f)
