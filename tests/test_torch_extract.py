"""Port's extraction (K4's plain twin) and LR gather (K5's plain twin) vs the
JAX reference's Pallas extraction, bit-exact on every map; the fused
extraction + LR route (K4 with K5's check in the same launch) against the
reference's last sweep with extraction, ``lr_gather_maps`` and its LR test
(``sgm_extract_fused_wdh``, interpret mode); the integer two-view path's
routing through that one wrapper call."""

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
from stereovisionarray_tpu.ops.sgm_pallas import sgm_extract_fused_wdh
from stereovisionarray_tpu_torch.ops import sgm as port_sgm
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    BIG_FLOAT,
    MAX_LR_WIDTH,
    _check_lr_width,
    extract_disparity_maps,
    extract_maps,
    extract_maps_plain,
    lr_check_plain,
    lr_gather,
    lr_gather_plain,
)
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float, sgm_aggregate_paths
from torch_launches import launched  # noqa: F401

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


def test_wrappers_run_plain_versions_on_cpu(total, launched):
    a = extract_maps(torch.from_numpy(total), True, 0.95)
    b = extract_maps_plain(torch.from_numpy(total), True, 0.95)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert launched == []


_LR_SHAPES = [(6, 21, 8), (5, 10, 16), (7, 13, 3)]  # W % 4 != 0; W < D; D = 3


@pytest.mark.parametrize("h,w,d,dtype,lr", [
    *((*shape, dtype, 1.5) for shape in _LR_SHAPES for dtype in ("int8", "int16", "float32")),
    *((*shape, dtype, 0.0) for shape, dtype in zip(_LR_SHAPES, ("float32", "int8", "int16"))),
])
def test_fused_lr_route_bit_exact_to_pallas(h, w, d, dtype, lr):
    """The plain composition of K4 with the fused LR check (maps, K5's
    gather, the test of ``sgm_pallas.py:1093-1095``) on the total the
    reference aggregates, against ``sgm_extract_fused_wdh`` in interpret
    mode: its last sweep with extraction (``_rl_extract_wdh``), then
    ``lr_gather_maps`` and the test. W not a multiple of 4, W < D, D = 3."""
    r = np.random.default_rng(h * w + d)
    img = r.uniform(0, 255, (h, w)).astype(np.float32)
    if dtype == "float32":
        vol = r.uniform(0, 60, (h, w, d)).astype(np.float32)
        p1, p2, p2_min = 4.0, 32.0, 8.0
    else:
        vol = r.integers(0, 71 if dtype == "int8" else 300, (h, w, d)).astype(dtype)
        p1, p2, p2_min = 32, 384, 96
    want = sgm_extract_fused_wdh(jnp.moveaxis(jnp.asarray(vol), -1, 1), None, p1, p2, 4,
                                 jnp.asarray(img), True, p2_min, True, 0.95, lr, interpret=True)
    v = torch.from_numpy(vol)
    p2_y, p2_x = port_sgm.p2_maps((h, w), p2, port_sgm.sum_dtype(v.dtype), v.device,
                                  torch.from_numpy(img), True, p2_min)
    total = (sgm_aggregate_float(v, p2_y, p2_x, p1, 4, order="wdh") if dtype == "float32"
             else sgm_aggregate_paths(v, p2_y, p2_x, p1, 4))
    got = extract_maps(total, True, 0.95, lr_max_diff=lr, right=False)
    assert got.disparity_right is None
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # K6's route over the same total is the same composition
    k6 = extract_disparity_maps(total, True, 0.95, lr)
    assert all(torch.equal(a, getattr(got, n)) for a, n in zip(k6, k6._fields))


@pytest.mark.parametrize("lr", [0.5, 1.5])
def test_fused_lr_check_is_the_two_step_check(total, lr, launched):
    """The fused route's validity is the uniqueness validity and-ed with the
    test on K5's standalone gather; ``right`` only drops the right map."""
    t = torch.from_numpy(total)
    plain = extract_maps_plain(t, True, 0.95)
    at = lr_gather(plain.disparity, plain.disparity_right, D)
    want = plain.valid & ((plain.disparity - at).abs() <= lr) & (at < BIG_FLOAT)
    for right in (True, False):
        got = extract_maps(t, True, 0.95, lr_max_diff=lr, right=right)
        assert torch.equal(got.valid, want)
        assert torch.equal(got.valid, lr_check_plain(plain.disparity, plain.disparity_right,
                                                     plain.valid, D, lr))
        assert (got.disparity_right is not None) == right
        if right:
            assert torch.equal(got.disparity_right, plain.disparity_right)
    assert not torch.equal(want, plain.valid)  # the check rejects some pixels here
    assert launched == []


def test_lr_width_limit():
    _check_lr_width(MAX_LR_WIDTH)
    with pytest.raises(ValueError, match="at most"):
        _check_lr_width(MAX_LR_WIDTH + 1)


def test_integer_two_view_route_fuses_the_lr_check(monkeypatch):
    """On a CUDA tensor the integer path makes one extraction call with the
    LR check and without the right map, and calls no standalone K5."""
    from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
    from stereovisionarray_tpu_torch.models import two_view as tv

    r = np.random.default_rng(8)
    base = r.uniform(0, 255, (10, 40)).astype(np.float32)
    left, right = torch.from_numpy(base[:, :32].copy()), torch.from_numpy(base[:, 8:].copy())
    cc = CostConfig(num_disparities=8, census_window=(3, 5), dtype="int16")
    sc = SGMConfig(uniqueness=0.9, lr_max_diff=1.25)
    want = tv.two_view_disparity(left, right, cc, sc)
    monkeypatch.setattr(tv, "resolve_backend", lambda t, b="auto": "cuda")
    calls = []
    for name in ("fused_cost_volume_cuda", "sgm_aggregate_paths", "extract_maps"):
        def fake(*args, _real=getattr(tv, name), _name=name, **kw):
            calls.append((_name, kw.get("lr_max_diff"), kw.get("right")))
            return _real(*(("torch" if a == "auto" else a) if isinstance(a, str) else a
                           for a in args), **kw)
        monkeypatch.setattr(tv, name, fake)
    got = tv.two_view_disparity(left, right, cc, sc)
    assert calls == [("fused_cost_volume_cuda", None, None), ("sgm_aggregate_paths", None, None),
                     ("extract_maps", 1.25, False)]
    assert not hasattr(tv, "lr_gather")
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
