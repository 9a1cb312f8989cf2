"""K9's plain twin (``ops/hatsample.py``) against the reference's Pallas
kernel in interpret mode, and against a numpy oracle of the docstring
formula where the reference departs from it (k1 < 0, ``hatsample.py:94``);
the 2-D form's plain twin against the reference's transpose + two
``hat_sample`` calls, the array cascade's pre-warp.

Tolerance against the reference: rtol 1e-6 (and atol 1e-6 for sums that
cancel to ~0). The reference's interpret-mode sum ``out + wgt * sl`` may be
contracted into a fused multiply-add by XLA on the CPU; the port rounds the
product and the sum separately, so the two differ by at most an ulp or two.
Bit for bit, the port is held to the formula summed over every tap in
float32 with the product and the sum rounded apart (``_formula``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops.hatsample import hat_sample as jax_hat_sample
from stereovisionarray_tpu_torch.ops.hatsample import (
    hat_sample,
    hat_sample_2d,
    hat_sample_2d_plain,
    hat_sample_plain,
)
from torch_launches import launched  # noqa: F401

RTOL = ATOL = 1e-6


def _oracle(values, t, k0, k1, aux=None, axis=-1):
    """The docstring formula in float64 over every tap of [k0, k1]."""
    values = np.asarray(values, np.float64)
    if axis == -2:
        values = np.swapaxes(values, -1, -2)
        t = np.swapaxes(t, -1, -2)
    w = values.shape[-1]
    out = np.zeros(values.shape)
    aout = np.zeros(values.shape)
    for k in range(k0, k1 + 1):
        idx = np.clip(np.arange(w) - k, 0, w - 1)
        wgt = np.maximum(0.0, 1.0 - np.abs(t.astype(np.float64) - k))
        out += wgt * values[..., idx]
        if aux is not None:
            aout += wgt * aux.astype(np.float64)[idx]
    if axis == -2:
        out = np.swapaxes(out, -1, -2)
    return out if aux is None else (out, aout)


def _inputs(seed, h, w, k0, k1, margin=1.5):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 255, (h, w)).astype(np.float32)
    t = rng.uniform(k0 - margin, k1 + margin, (h, w)).astype(np.float32)
    t[0, :5] = (k0, k1, k0 - 0.25, k1 + 0.25, k0 + 0.5)  # range edges, partial weights
    t[1, :2] = (k0 - 40.0, k1 + 40.0)  # far outside: zero
    return values, t, rng.uniform(-30, 30, (w,)).astype(np.float32)


@pytest.mark.parametrize("k0,k1", [(-7, 7), (0, 15), (-12, 3)])
@pytest.mark.parametrize("with_aux", [False, True])
def test_plain_twin_matches_reference(k0, k1, with_aux):
    values, t, aux = _inputs(3, 24, 160, k0, k1)
    a = aux if with_aux else None
    want = jax_hat_sample(jnp.asarray(values), jnp.asarray(t), k0, k1,
                          aux=None if a is None else jnp.asarray(a), interpret=True)
    got = hat_sample(torch.from_numpy(values), torch.from_numpy(t), k0, k1,
                     aux=None if a is None else torch.from_numpy(a))
    pairs = zip(got, want) if with_aux else [(got, want)]
    for g, wnt in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k0,k1", [(-9, -2), (-5, -1)])
def test_negative_k1_follows_the_formula(k0, k1):
    """With k1 < 0 the reference reads values(x + k1 - k) (its left pad is
    max(k1, 0), ``hatsample.py:94``); the port samples values(x - k), the
    formula of both docstrings, held here to a float64 numpy oracle."""
    values, t, aux = _inputs(4, 10, 50, k0, k1)
    got = hat_sample(torch.from_numpy(values), torch.from_numpy(t), k0, k1,
                     aux=torch.from_numpy(aux))
    want = _oracle(values, t, k0, k1, aux)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-5, atol=1e-3)
    ref = np.asarray(jax_hat_sample(jnp.asarray(values), jnp.asarray(t), k0, k1,
                                    interpret=True))
    assert not np.allclose(ref, want[0], rtol=1e-5, atol=1e-3)  # the reference's divergence


@pytest.mark.parametrize("k0,k1", [(-7, 7), (0, 23), (-3, -3)])
def test_row_axis_and_batch(k0, k1):
    """axis=-2 equals the column sampler on the transposed maps, and a batch
    of maps equals each map sampled alone."""
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.uniform(0, 255, (3, 17, 29)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(k0 - 1.5, k1 + 1.5, (3, 17, 29)).astype(np.float32))
    rows = hat_sample(values, t, k0, k1, axis=-2)
    cols = hat_sample(values.transpose(1, 2).contiguous(), t.transpose(1, 2).contiguous(),
                      k0, k1)
    assert torch.equal(rows, cols.transpose(1, 2))
    for i in range(3):
        assert torch.equal(hat_sample(values[i], t[i], k0, k1), hat_sample(values, t, k0, k1)[i])
    np.testing.assert_allclose(rows.numpy(), _oracle(values.numpy(), t.numpy(), k0, k1, axis=-2),
                               rtol=1e-5, atol=1e-3)


def test_cpu_routes_and_validation():
    values, t, aux = _inputs(6, 8, 12, -2, 2)
    v, tt = torch.from_numpy(values), torch.from_numpy(t)
    assert torch.equal(hat_sample(v, tt, -2, 2, backend="torch"), hat_sample_plain(v, tt, -2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hat_sample(v, tt, -2, 2, backend="cuda")
    with pytest.raises(ValueError, match="aux"):
        hat_sample(v, tt, -2, 2, aux=torch.from_numpy(aux), axis=-2)
    with pytest.raises(ValueError, match="empty"):
        hat_sample(v, tt, 2, -2)
    with pytest.raises(ValueError, match="shape"):
        hat_sample(v, tt[:, :5], -2, 2)


def _formula(values, t, k0, k1, axis=-1):
    """The formula in float32 over every tap of [k0, k1] in ascending k, each
    product and each sum rounded on its own (numpy does not contract)."""
    if axis == -2:
        values, t = np.swapaxes(values, -1, -2), np.swapaxes(t, -1, -2)
    w = values.shape[-1]
    out = np.zeros(values.shape, np.float32)
    for k in range(k0, k1 + 1):
        wgt = np.maximum(np.float32(0), np.float32(1) - np.abs(t - np.float32(k)))
        out = out + wgt * values[..., np.clip(np.arange(w) - k, 0, w - 1)]
    return np.swapaxes(out, -1, -2) if axis == -2 else out


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("pad", [2, 7, 12])
def test_2d_plain_twin_matches_reference_prewarp(pad, batch):
    """hat_sample_2d's plain twin against the reference's pre-warp
    (``models/cascade_sweep.py:318-321``: the transposed map sampled along
    columns, transposed back, then sampled along columns), every map alone;
    t within the tap range, on its edges and far outside it."""
    shape = (11, 37) if batch is None else (batch, 11, 37)
    rng = np.random.default_rng(pad)
    values = rng.uniform(0, 255, shape).astype(np.float32)
    t_rows, t_cols = (rng.uniform(-pad - 1.5, pad + 1.5, shape).astype(np.float32)
                      for _ in range(2))
    t_rows.reshape(-1, 37)[0, :3] = (-pad - 40.0, pad + 0.25, -pad)
    t_cols.reshape(-1, 37)[1, :3] = (pad + 40.0, -pad - 0.5, pad)
    got = hat_sample_2d(torch.from_numpy(values), torch.from_numpy(t_rows),
                        torch.from_numpy(t_cols), -pad, pad).numpy()
    maps = [(values, t_rows, t_cols)] if batch is None else list(zip(values, t_rows, t_cols))
    want = []
    for v, tr, tc in maps:
        tmp = jax_hat_sample(jnp.asarray(v).T, jnp.asarray(tr).T, -pad, pad, interpret=True).T
        want.append(np.asarray(jax_hat_sample(tmp, jnp.asarray(tc), -pad, pad, interpret=True)))
    want = want[0] if batch is None else np.stack(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    oracle = _formula(_formula(values, t_rows, -pad, pad, axis=-2), t_cols, -pad, pad)
    np.testing.assert_array_equal(got, oracle)


def test_2d_is_two_passes_and_validates(launched):
    values, t, _ = _inputs(7, 9, 14, -3, 3)
    t2 = np.roll(t, 1, axis=1)
    v, tr, tc = (torch.from_numpy(a) for a in (values, t, t2))
    two = hat_sample(hat_sample(v, tr, -3, 3, axis=-2), tc, -3, 3)
    assert torch.equal(hat_sample_2d(v, tr, tc, -3, 3), two)
    assert torch.equal(hat_sample_2d(v, tr, tc, -3, 3, backend="torch"),
                       hat_sample_2d_plain(v, tr, tc, -3, 3))
    assert launched == []
    with pytest.raises(ValueError, match="CUDA tensor"):
        hat_sample_2d(v, tr, tc, -3, 3, backend="cuda")
    with pytest.raises(ValueError, match="shape"):
        hat_sample_2d(v, tr, tc[:, :5], -3, 3)
