"""Port's extraction (K4's plain twin) and LR gather (K5's plain twin) vs the
JAX reference's Pallas extraction, bit-exact on every map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops.extract_pallas import (
    _barrel,
    _subpixel,
    _wta_row,
    extract_maps_hdw,
    lr_gather_maps,
)
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    BIG_FLOAT,
    extract_maps,
    extract_maps_plain,
    lr_gather,
    lr_gather_plain,
)

H, W, D = 12, 40, 16


@pytest.fixture(scope="module")
def total():
    """An int16 SGM total holding the cases extraction must break alike."""
    a = np.random.default_rng(11).integers(50, 400, (H, W, D)).astype(np.int16)
    a[0, :, 3] = a[0, :, 9] = 10  # exact tie far apart: winner d=3, second 10
    a[1, :, 0] = 5  # winner at d = 0
    a[2, :, D - 1] = 5  # winner at d = D-1
    a[3, :, 5] = a[3, :, 6] = 7  # adjacent tie
    a[4] = 100  # flat: every d ties, zero parabola denominator
    a[5, :, 7], a[5, :, 8], a[5, :, 6] = 20, 21, 21  # symmetric neighbours: delta 0
    # costs above BIG: out-of-image right-view candidates (BIG) win there
    a[6] = 16500 + np.random.default_rng(1).integers(0, 50, (W, D))
    a[7, :, 2] = a[7, :, 13] = 3  # right-view ties through the anti-diagonal
    return a


def _ref_right_view(a, subpixel):
    """Right-view subpixel map from the reference's own row functions:
    ar[d, x] = a[d, x + d] (BIG past the border), packed WTA, parabola."""
    rows = []
    for y in range(a.shape[0]):
        a16 = jnp.asarray(a[y].T)  # (D, W) int16
        d_iota = jax.lax.broadcasted_iota(jnp.int32, a16.shape, 0)
        ar = _barrel(a16, d_iota, D, left=True, fill=16000).astype(jnp.int32)
        _, dr_int, dr_c, rm, r0, rp, _ = _wta_row(ar, d_iota, D)
        dr = (_subpixel(dr_int, dr_c, rm, r0, rp, D, jnp.int32) if subpixel
              else dr_int.astype(jnp.float32))
        rows.append(np.asarray(dr)[0])
    return np.stack(rows)


@pytest.mark.parametrize("uniqueness", [0.0, 0.95])
@pytest.mark.parametrize("subpixel", [True, False])
def test_left_maps_and_second_bit_exact(total, subpixel, uniqueness):
    want = extract_maps_hdw(jnp.moveaxis(jnp.asarray(total), -1, 1), subpixel=subpixel,
                            uniqueness=uniqueness, lr_max_diff=0.0, interpret=True)
    got = extract_maps_plain(torch.from_numpy(total), subpixel, uniqueness)
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("subpixel", [True, False])
def test_right_view_bit_exact(total, subpixel):
    got = extract_maps_plain(torch.from_numpy(total), subpixel, 0.95)
    np.testing.assert_array_equal(got.disparity_right.numpy(),
                                  _ref_right_view(total, subpixel))


@pytest.mark.parametrize("subpixel", [True, False])
def test_final_validity_with_lr_check_bit_exact(total, subpixel):
    want = extract_maps_hdw(jnp.moveaxis(jnp.asarray(total), -1, 1), subpixel=subpixel,
                            uniqueness=0.95, lr_max_diff=1.5, interpret=True)
    maps = extract_maps(torch.from_numpy(total), subpixel, 0.95)
    at = lr_gather(maps.disparity, maps.disparity_right, D)
    valid = maps.valid & ((maps.disparity - at).abs() <= 1.5) & (at < BIG_FLOAT)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(maps.disparity.numpy(), np.asarray(want.disparity))


def test_lr_gather_bit_exact():
    r = np.random.default_rng(4)
    disp_l = r.uniform(0, D - 1, (H, W)).astype(np.float32)
    disp_l[:, ::3] = np.floor(disp_l[:, ::3]) + 0.5  # half-way: round half to even
    disp_l[0, :] = D + 3.7  # beyond the range: clipped to D-1
    disp_r = r.uniform(0, D - 1, (H, W)).astype(np.float32)
    want = np.asarray(lr_gather_maps(jnp.asarray(disp_l), jnp.asarray(disp_r), D,
                                     interpret=True))
    got = lr_gather_plain(torch.from_numpy(disp_l), torch.from_numpy(disp_r), D)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, :3] == BIG_FLOAT).any()  # sources left of the image


def test_wrappers_run_plain_versions_on_cpu(total):
    a = extract_maps(torch.from_numpy(total), True, 0.95)
    b = extract_maps_plain(torch.from_numpy(total), True, 0.95)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert extract_maps.launches == 0 and lr_gather.launches == 0
