"""The port's two-view cascade (``models/cascade.py``) against the JAX
reference's integer route (``backend="pallas_interpret"``: the integer
two-view path and K9 in interpret mode), and its float helpers against the
JAX functions they replace.

Tolerances, and why:
 - band mode is held bit-exact: its glue is integer rounding and gathers;
 - smooth mode runs float glue that the reference compiles with fused
   multiply-adds and XLA's summation orders (its box filter's cumulative sum,
   the column mean, the convolution, the hat-matrix product), so the warped
   right view differs in the last bits and flips census bits at near-ties of
   the fine pass. It is held to the bar of scripts/check_tpu_parity.py:47-55:
   validity agreement >= 0.97 and |d - d_ref| <= 0.5 px on >= 99% of the
   pixels valid in both;
 - the upsampled coarse map is within 1e-5 relative (the reference's
   resize contracts with an FMA-capable product);
 - the smooth shift field ``band_offset`` is within 3e-5 of the field's
   range (measured 0.6e-5 to 1.5e-5 at this shape, depending on the CPU
   thread count, which changes PyTorch's reduction order: the box filter's
   cumulative sums and the column mean differ from XLA's in order, and the
   residual solve amplifies by 1 / (1 - g'));
 - the confidence agrees to 1e-6 on >= 98.5% of the pixels whose disparity
   agrees to 1e-3 px (measured 99.4% int8, 99.6% int16 at this shape): a
   census bit flipped by the last-bit differences moves a cost, and a
   near-tie of the second-best cost moves the rest.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.models import cascade as jcascade
from stereovisionarray_tpu_torch.datasets.synthetic import large_range_pair
from stereovisionarray_tpu_torch.evaluation import cascade_disparity_metrics
from stereovisionarray_tpu_torch.models import cascade as tcascade
from stereovisionarray_tpu_torch.models import cascade_two_view_disparity, disparity_to_depth

H, W, TOTAL, FINE = 64, 256, 128, 32
SGM = SGMConfig(p1=6.0, p2=64.0)
COMBOS = [("smooth", "int8"), ("smooth", "int16"), ("band", "int8"), ("band", "int16")]


def _texture(rng, h, w):
    t = rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)
    for _ in range(2):
        t = (t + np.roll(t, 1, 0) + np.roll(t, -1, 0)) / 3.0
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)) / 3.0
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair():
    """Two fronto-parallel planes at disparities 40 and 88 (past the fine window)."""
    big = _texture(np.random.default_rng(11), H, W + TOTAL)
    u = np.arange(W)
    right = big[:, u + np.where(u < W // 2, 40, 88)]
    return np.ascontiguousarray(big[:, :W]), np.ascontiguousarray(right)


@functools.lru_cache(maxsize=None)
def _runs(mode, dtype):
    left, right = _pair()
    cc = CostConfig(num_disparities=TOTAL, dtype=dtype)
    kw = dict(fine_disparities=FINE, band_step=8, mode=mode, baseline=0.1, focal_px=500.0)
    want = jcascade.cascade_two_view_disparity(jnp.asarray(left), jnp.asarray(right), cc, SGM,
                                               backend="pallas_interpret", **kw)
    got = cascade_two_view_disparity(torch.from_numpy(left), torch.from_numpy(right), cc, SGM, **kw)
    return jax.tree_util.tree_map(np.asarray, tuple(want)), got


@pytest.mark.parametrize("mode,dtype", COMBOS)
def test_disparity_matches_reference(mode, dtype):
    want, got = _runs(mode, dtype)
    vw, vg = want[1], got.valid.numpy()
    if mode == "band":
        for i, name in enumerate(("disparity", "valid", "cost")):
            np.testing.assert_array_equal(getattr(got, name).numpy(), want[i], err_msg=name)
        return
    assert (vw == vg).mean() >= 0.97
    both = vw & vg
    assert both.mean() > 0.5
    assert (np.abs(got.disparity.numpy() - want[0])[both] <= 0.5).mean() >= 0.99
    assert (got.disparity.numpy()[~vg] == -1.0).all()


@pytest.mark.parametrize("mode,dtype", COMBOS)
def test_coarse_and_offset_fields_match_reference(mode, dtype):
    want, got = _runs(mode, dtype)
    coarse, offset = want[5], want[6]
    np.testing.assert_allclose(got.coarse_disparity.numpy(), coarse, rtol=1e-5, atol=1e-5)
    if mode == "band":
        np.testing.assert_array_equal(got.band_offset.numpy(), offset)
    else:
        span = np.abs(offset).max()
        assert np.abs(got.band_offset.numpy() - offset).max() <= 3e-5 * span


@pytest.mark.parametrize("mode,dtype", COMBOS)
def test_confidence_and_depth(mode, dtype):
    want, got = _runs(mode, dtype)
    conf, valid = got.confidence.numpy(), got.valid.numpy()
    assert not conf[~valid].any() and (conf[valid] >= 0).all() and (conf[valid] < 1).all()
    same = valid & want[1] & (np.abs(got.disparity.numpy() - want[0]) <= 1e-3)
    assert same.sum() > 0.9 * valid.sum()
    assert (np.abs(conf[same] - want[4][same]) <= 1e-6).mean() >= 0.985
    depth = disparity_to_depth(torch.where(got.valid, got.disparity, 0.0), 0.1, 500.0)
    assert torch.equal(got.depth, depth)


def test_torch_backend_equals_auto_on_cpu():
    left, right = (torch.from_numpy(a) for a in _pair())
    cc = CostConfig(num_disparities=TOTAL, dtype="int8")
    a = cascade_two_view_disparity(left, right, cc, SGM, fine_disparities=FINE)
    b = cascade_two_view_disparity(left, right, cc, SGM, fine_disparities=FINE, backend="torch")
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cascade_two_view_disparity(left, right, cc, SGM, fine_disparities=FINE, backend="cuda")


@pytest.mark.parametrize("total,fine,step,mode", [(32, 32, 8, "smooth"), (128, 12, 8, "smooth"),
                                                  (128, 8, 8, "band"), (128, 32, 8, "nearest")])
def test_rejects_the_reference_configs(total, fine, step, mode):
    """The ValueErrors of cascade.py:265-270, with the reference's messages."""
    left, right = _pair()
    cc = CostConfig(num_disparities=total)
    kw = dict(fine_disparities=fine, band_step=step, mode=mode)
    with pytest.raises(ValueError) as want:
        jcascade.cascade_two_view_disparity(jnp.asarray(left), jnp.asarray(right), cc, SGM, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        cascade_two_view_disparity(torch.from_numpy(left), torch.from_numpy(right), cc, SGM, **kw)


def test_large_range_pair_is_perf_cascade_scene():
    import sys

    sys.path.insert(0, str(chip_smoke.REPO / "scripts"))
    try:
        from perf_cascade import make_scene
    finally:
        sys.path.remove(str(chip_smoke.REPO / "scripts"))
    for a, b in zip(large_range_pair(np.random.default_rng(0), 60, 96, margin=48),
                    make_scene(np.random.default_rng(0), 60, 96)):
        np.testing.assert_array_equal(a, b)


def test_cascade_golden_on_cpu():
    """The full-size two-view cascade on the CPU lands within
    CASCADE_GOLDEN_TOL of the reference's metrics."""
    got = chip_smoke.two_view_cascade_metrics(torch, torch.device("cpu"))
    want = chip_smoke.CASCADE_GOLDEN["two_view"]
    for m, tol in chip_smoke.CASCADE_GOLDEN_TOL["two_view"].items():
        assert abs(got[m] - want[m]) <= tol, (m, got)


@pytest.mark.slow
def test_cascade_golden_reference_recompute():
    """Recomputes CASCADE_GOLDEN["two_view"] with JAX at full size
    (540x768, 256 disparities; about 40 s on a CPU)."""
    left, right, gt, mask = large_range_pair(np.random.default_rng(0), *chip_smoke.CASCADE_SHAPE[:2])
    cost, sgm, kw = chip_smoke.two_view_cascade_config(CostConfig, SGMConfig)
    out = jcascade.cascade_two_view_disparity(jnp.asarray(left), jnp.asarray(right), cost, sgm,
                                              backend="pallas_interpret", **kw)
    got = cascade_disparity_metrics(np.asarray(out.disparity), gt, mask)
    assert got == pytest.approx(chip_smoke.CASCADE_GOLDEN["two_view"], rel=0, abs=1e-7)


# ---- float helpers against the JAX functions they replace ----------------------------------------

@pytest.mark.parametrize("shape,factor", [((17, 48), 4), ((9, 13), 2), ((6, 5), 3)])
def test_resize_linear_matches_jax_image_resize(shape, factor):
    x = np.random.default_rng(1).uniform(0, 100, shape).astype(np.float32)
    out_shape = (shape[0] * factor, shape[1] * factor)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, out_shape, method="linear"))(x))
    got = tcascade.resize_linear(torch.from_numpy(x), out_shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gradient_matches_jnp_gradient_exactly(axis):
    x = np.random.default_rng(2).uniform(-50, 50, (7, 11)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.gradient(a, axis=axis))(x))
    np.testing.assert_array_equal(tcascade.gradient(torch.from_numpy(x), axis).numpy(), want)


@pytest.mark.parametrize("n,k", [(40, 9), (5, 9), (12, 3), (12, 4)])
def test_convolve_same_matches_jnp_convolve(n, k):
    """jnp.convolve swaps its operands when the kernel is the longer one."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, n).astype(np.float32)
    v = rng.uniform(0, 1, k).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jnp.convolve(x, y, mode="same"))(a, v))
    got = tcascade.convolve_same(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_column_warp_matches_hat_matmul():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (6, 50)).astype(np.float32)
    g = rng.uniform(-8, 60, 50).astype(np.float32)
    g[:3] = (0.0, 49.0, -3.0)  # integer shifts and clipping at both ends
    want = np.asarray(jax.jit(jcascade._hat_matmul_warp)(img, g))
    got = tcascade._column_warp(torch.from_numpy(img), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-5)


def test_box_mean_matches_reference():
    x = np.random.default_rng(5).uniform(0, 200, (30, 41)).astype(np.float32)
    for k in (9, 25):
        want = np.asarray(jax.jit(lambda a: jcascade._box_mean(a, k))(x))
        np.testing.assert_allclose(tcascade.box_mean(torch.from_numpy(x), k).numpy(), want,
                                   rtol=1e-5)
