"""Port's census and cost volume vs the JAX reference: integer volumes
bit-exact, float32 at atol 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops import cost_volume as ref
from stereovisionarray_tpu.ops.census import census_transform as ref_census
from stereovisionarray_tpu.ops.census import hamming_distance as ref_hamming
from stereovisionarray_tpu.ops.cost_pallas import (
    fused_cost_volume_pallas_hdw,
    fused_cost_volume_pallas_wdh,
)
from stereovisionarray_tpu_torch.ops import cost_volume as port
from stereovisionarray_tpu_torch.ops.census import census_transform, hamming_distance
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda


def _pair(w, seed=0, integer=False):
    b = np.random.default_rng(seed).uniform(0, 255, (24, w + 16)).astype(np.float32)
    if integer:  # 8-bit frames: exact .5 ties at int8 scale 1
        b = np.floor(b)
    return np.ascontiguousarray(b[:, :w]), np.ascontiguousarray(b[:, 16:])


@pytest.mark.parametrize("window", [(5, 5), (7, 9), (11, 13)])
def test_census_and_hamming_match_reference(window):
    l, r = _pair(40, seed=1, integer=True)
    want = np.asarray(ref_census(jnp.asarray(l), window))
    got = census_transform(torch.from_numpy(l), window)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    want_h = np.asarray(ref_hamming(jnp.asarray(want), jnp.asarray(np.asarray(
        ref_census(jnp.asarray(r), window)))))
    got_h = hamming_distance(got, census_transform(torch.from_numpy(r), window))
    np.testing.assert_array_equal(got_h.numpy(), want_h)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
@pytest.mark.parametrize("w", [80, 70])
@pytest.mark.parametrize("bt_weight", [0.0, 0.25])
@pytest.mark.parametrize("window", [(5, 5), (7, 9)])
@pytest.mark.parametrize("D", [12, 16, 32])
def test_fused_cost_volume_matches_reference(D, window, bt_weight, w, dtype):
    l, r = _pair(w, seed=D, integer=dtype == "int8")
    want = np.asarray(ref.fused_cost_volume(jnp.asarray(l), jnp.asarray(r), D, window,
                                            bt_weight, 32.0, dtype=jnp.dtype(dtype),
                                            layout="hwd"))
    got = port.fused_cost_volume(torch.from_numpy(l), torch.from_numpy(r), D, window,
                                 bt_weight, 32.0, dtype=dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D,window,bt_weight,dtype", [
    (16, (5, 5), 0.25, "int16"),
    (32, (7, 9), 0.25, "int8"),
])
def test_cost_wrapper_matches_pallas_wdh_builder(D, window, bt_weight, dtype):
    l, r = _pair(80, seed=3, integer=True)
    want = np.asarray(fused_cost_volume_pallas_wdh(
        jnp.asarray(l), jnp.asarray(r), D, census_window=window, bt_weight=bt_weight,
        block_rows=16, interpret=True, out_dtype=dtype))  # (W, D, H)
    got = fused_cost_volume_cuda(torch.from_numpy(l), torch.from_numpy(r), D, window,
                                 bt_weight, 32.0, dtype)
    np.testing.assert_array_equal(got.numpy(), want.transpose(2, 0, 1))


@pytest.mark.parametrize("D,window,bt_weight,dtype", [
    (12, (5, 5), 0.0, "int16"),
    (16, (7, 9), 0.25, "int8"),
])
def test_cost_wrapper_matches_pallas_hdw_builder(D, window, bt_weight, dtype):
    l, r = _pair(70, seed=4, integer=True)  # W % 8 != 0: the reference's fallback builder
    want = np.asarray(fused_cost_volume_pallas_hdw(
        jnp.asarray(l), jnp.asarray(r), D, census_window=window, bt_weight=bt_weight,
        interpret=True, out_dtype=dtype))  # (H, D, W)
    got = fused_cost_volume_cuda(torch.from_numpy(l), torch.from_numpy(r), D, window,
                                 bt_weight, 32.0, dtype)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 1))


def test_right_from_left_volume_matches_reference():
    vol = np.random.default_rng(2).uniform(0, 50, (6, 20, 8)).astype(np.float32)
    want = np.asarray(ref.right_from_left_volume(jnp.asarray(vol)))
    np.testing.assert_array_equal(port.right_from_left_volume(torch.from_numpy(vol)).numpy(),
                                  want)


@pytest.mark.parametrize("window,bt_weight", [((7, 9), 0.25), ((11, 13), 0.25),
                                              ((11, 11), 0.0), ((9, 15), 0.5)])
def test_int8_fit_and_scale_match_reference(window, bt_weight):
    assert port.int8_cost_fits(window, bt_weight, 32.0) == ref.int8_cost_fits(
        window, bt_weight, 32.0)
    for dtype in ("int8", "int16", "float32"):
        assert port.cost_scale_for(dtype) == ref.cost_scale_for(jnp.dtype(dtype))


def test_int8_overflow_is_refused():
    l, r = _pair(40)
    with pytest.raises(ValueError):
        port.fused_cost_volume(torch.from_numpy(l), torch.from_numpy(r), 8, (11, 13),
                               dtype="int8")
