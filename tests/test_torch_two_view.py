"""The port's two-view pipeline vs the JAX reference at a small shape: the
integer path bit-exact to backend="pallas_interpret", float32 against the
XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models.two_view import disparity_to_depth as ref_d2z
from stereovisionarray_tpu.models.two_view import depth_to_disparity as ref_z2d
from stereovisionarray_tpu.models.two_view import two_view_disparity as ref_two_view
from stereovisionarray_tpu_torch.models import (
    depth_to_disparity,
    disparity_to_depth,
    two_view_disparity,
)

H, W, D, SHIFT = 40, 72, 16, 16


@pytest.fixture(scope="module")
def scene():
    r = np.random.default_rng(5)
    base = r.uniform(0, 255, (H, W + SHIFT)).astype(np.float32)
    left, right = np.ascontiguousarray(base[:, :W]), np.ascontiguousarray(base[:, SHIFT:])
    mask = r.uniform(size=(H, W)) > 0.2  # ROI
    return left, right, mask


def _both(scene, cc, sc, ref_backend, **kw):
    left, right, mask = scene
    want = ref_two_view(jnp.asarray(left), jnp.asarray(right), cc, sc, mask=jnp.asarray(mask),
                        backend=ref_backend, **kw)
    got = two_view_disparity(torch.from_numpy(left), torch.from_numpy(right), cc, sc,
                             mask=torch.from_numpy(mask), **kw)
    return want, got


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_integer_path_bit_exact_to_pallas(scene, dtype, num_paths):
    cc = CostConfig(num_disparities=D, census_window=(5, 5), dtype=dtype)
    sc = SGMConfig(num_paths=num_paths, uniqueness=0.95, lr_max_diff=1.25)
    want, got = _both(scene, cc, sc, "pallas_interpret", baseline=0.12, focal_px=700.0)
    for name in ("disparity", "valid", "cost", "depth"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), atol=1e-6)
    assert got.valid.any() and not got.valid[~torch.from_numpy(scene[2])].any()


@pytest.mark.parametrize("num_paths", [4, 8])
def test_float_path_matches_xla(scene, num_paths):
    cc = CostConfig(num_disparities=D, census_window=(5, 5), dtype="float32")
    sc = SGMConfig(num_paths=num_paths, uniqueness=0.95, lr_max_diff=1.25)
    want, got = _both(scene, cc, sc, "xla")
    inner = np.s_[:, : W - D]
    vw, vg = np.asarray(want.valid)[inner], got.valid.numpy()[inner]
    np.testing.assert_array_equal(vg, vw)
    np.testing.assert_allclose(got.disparity.numpy()[inner][vg],
                               np.asarray(want.disparity)[inner][vw], atol=1e-4)


def test_int8_widens_for_large_census_window(scene):
    left, right, _ = scene
    sc = SGMConfig(num_paths=4)
    args = (torch.from_numpy(left), torch.from_numpy(right))
    a = two_view_disparity(*args, CostConfig(num_disparities=D, census_window=(11, 13),
                                             dtype="int8"), sc)
    b = two_view_disparity(*args, CostConfig(num_disparities=D, census_window=(11, 13),
                                             dtype="int16"), sc)
    assert torch.equal(a.disparity, b.disparity) and torch.equal(a.cost, b.cost)


@pytest.mark.parametrize("option", [dict(median_filter=True), dict(speckle_window=50),
                                    dict(fill_holes=True)])
def test_postfilters_are_not_ported_yet(scene, option):
    left, right, _ = scene
    with pytest.raises(NotImplementedError, match="postfilter"):
        two_view_disparity(torch.from_numpy(left), torch.from_numpy(right),
                           CostConfig(num_disparities=D), SGMConfig(**option))


def test_depth_conversions_match_reference():
    d = np.random.default_rng(0).uniform(-1, 40, (8, 9)).astype(np.float32)
    d[0, :3] = (0.0, 1e-7, -1.0)
    np.testing.assert_array_equal(disparity_to_depth(torch.from_numpy(d), 0.12, 700.0).numpy(),
                                  np.asarray(ref_d2z(jnp.asarray(d), 0.12, 700.0)))
    np.testing.assert_array_equal(depth_to_disparity(torch.from_numpy(d), 0.12, 700.0).numpy(),
                                  np.asarray(ref_z2d(jnp.asarray(d), 0.12, 700.0)))
