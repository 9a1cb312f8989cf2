"""The port's disparity post-filters against the JAX reference
(``stereovisionarray_tpu/ops/postfilter.py``), bit-exact: the median is one
of its nine values, the speckle support a small integer count, and the hole
fill copies values, so no tolerance is needed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops import postfilter as jpf
from stereovisionarray_tpu_torch.ops import postfilter as pf


def _maps(seed, h, w, p_valid=0.7, hi=64.0):
    """A blocky disparity map (so windows hold near-equal neighbours), with
    INVALID_DISPARITY wherever the validity mask is off."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, hi, (h // 4 + 1, w // 4 + 1)).repeat(4, 0).repeat(4, 1)[:h, :w]
    d = (d + rng.normal(0, 0.6, (h, w))).astype(np.float32)
    v = rng.uniform(size=(h, w)) < p_valid
    return np.where(v, d, np.float32(-1.0)), v


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("h,w", [(23, 41), (1, 9), (7, 1)])
def test_median3x3(h, w, with_valid):
    d, v = _maps(0, h, w)
    jv = jnp.asarray(v) if with_valid else None
    tv = torch.from_numpy(v) if with_valid else None
    _eq(pf.median3x3(torch.from_numpy(d), tv), jpf.median3x3(jnp.asarray(d), jv))


@pytest.mark.parametrize("max_diff,window,min_support", [(1.0, 9, 12), (1.5, 5, 8),
                                                         (2.0, 5, 8), (0.5, 3, 2)])
@pytest.mark.parametrize("with_valid", [True, False])
def test_speckle_filter(max_diff, window, min_support, with_valid):
    d, v = _maps(1, 31, 45)
    jv = jnp.asarray(v) if with_valid else None
    tv = torch.from_numpy(v) if with_valid else None
    got = pf.speckle_filter(torch.from_numpy(d), tv, max_diff, window, min_support)
    want = jpf.speckle_filter(jnp.asarray(d), jv, max_diff, window, min_support)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert 0 < got[1].sum() < got[1].numel()


@pytest.mark.parametrize("take", ["min", "max"])
@pytest.mark.parametrize("max_span", [None, 1, 2, 3, 5, 8, 32, 1000])
@pytest.mark.parametrize("p_valid", [0.5, 0.1])
def test_fill_holes(take, max_span, p_valid):
    d, v = _maps(2, 19, 70, p_valid=p_valid)
    v[3] = False  # a fully invalid row stays unfilled
    v[4, :] = False
    v[4, 10] = True  # a single valid pixel: holes on both sides are one-sided
    v[5, :] = False
    v[5, -1] = True  # only a right border source
    v[6, :] = False
    v[6, 0] = True  # only a left border source
    d = np.where(v, d, np.float32(-1.0))
    got = pf.fill_holes(torch.from_numpy(d), torch.from_numpy(v), max_span, take)
    want = jpf.fill_holes(jnp.asarray(d), jnp.asarray(v), max_span, take)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert not got[1][3].any()


def test_fill_holes_infers_validity_and_rejects_bad_take():
    d, _ = _maps(3, 9, 33, p_valid=0.4)
    got = pf.fill_holes(torch.from_numpy(d))
    want = jpf.fill_holes(jnp.asarray(d))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    with pytest.raises(ValueError, match="take"):
        pf.fill_holes(torch.from_numpy(d), take="mean")


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -2), (-3, 4), (2, 0)])
def test_shifted_matches_reference(dy, dx):
    d, _ = _maps(4, 11, 13)
    _eq(pf.shifted(torch.from_numpy(d), dy, dx), jpf._shifted(jnp.asarray(d), dy, dx))
