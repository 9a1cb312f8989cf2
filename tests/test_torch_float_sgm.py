"""The float-cost kernels' plain twins against the JAX reference's Pallas
kernels in interpret mode, bit-exact: the float SGM sums (K7 and its sweep
subsets, K10, the K11 pair, K12 and the wdh order of
``sgm_extract_fused_wdh``), each in the reference's own summation order with
its fused multiply-add rows, and the standalone extraction K6 over float32,
int8 and int16 volumes. Plus the routing of every float route through the
kernel wrappers when the backend resolves to "cuda"."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops import sgm_pallas as sp
from stereovisionarray_tpu.ops.extract_pallas import extract_disparity_hdw, extract_maps_hdw
from stereovisionarray_tpu_torch.ops import sgm as port
from stereovisionarray_tpu_torch.ops import sgm_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    extract_disparity,
    extract_disparity_maps,
)
from torch_launches import launched  # noqa: F401

H, W, D = 12, 16, 8
P1, P2, P2_MIN = 4.0, 32.0, 8.0


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    vol = r.uniform(0, 60, (H, W, D)).astype(np.float32)
    img = r.uniform(0, 255, (H, W)).astype(np.float32)
    return vol, img


def _maps(data, adaptive):
    vol, img = data
    return port.p2_maps((H, W), P2, torch.float32, torch.device("cpu"), torch.from_numpy(img),
                        adaptive, P2_MIN)


def _hdw(a):
    return jnp.moveaxis(jnp.asarray(a), -1, 1)


def _hwd(a):
    return np.moveaxis(np.asarray(a), 1, -1)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_k7_bit_exact_to_pallas(data, num_paths, adaptive):
    """8 paths: the up group's first row is fma(3, C, down) in the reference."""
    vol, img = data
    want = _hwd(sp.sgm_aggregate_pallas_hdw(_hdw(vol), P1, P2, num_paths, jnp.asarray(img),
                                            adaptive, P2_MIN, interpret=True))
    p2_y, p2_x = _maps(data, adaptive)
    got = sgm_cuda.sgm_aggregate_float(torch.from_numpy(vol), p2_y, p2_x, P1, num_paths,
                                       order="k7")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sweeps", [("down",), ("up", "rl"), ("down", "up", "lr")])
def test_k7_sweep_subsets_bit_exact_to_pallas(data, sweeps):
    vol, img = data
    want = _hwd(sp.sgm_aggregate_pallas_sweeps(_hdw(vol), sweeps, P1, P2, 8, jnp.asarray(img),
                                               True, P2_MIN, interpret=True))
    p2_y, p2_x = _maps(data, True)
    got = sgm_cuda.sgm_aggregate_float(torch.from_numpy(vol), p2_y, p2_x, P1, 8, sweeps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_k10_bit_exact_to_pallas(data, num_paths):
    vol, img = data
    want = np.asarray(sp.sgm_aggregate_pallas(jnp.asarray(vol), P1, P2, num_paths,
                                              jnp.asarray(img), True, P2_MIN, interpret=True))
    got = sgm_cuda.sgm_aggregate_hwd(torch.from_numpy(vol), P1, P2, num_paths,
                                     torch.from_numpy(img), True, P2_MIN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k10_int16_keeps_the_volume_dtype(data):
    _, img = data
    vol = np.random.default_rng(2).integers(0, 300, (H, W, D)).astype(np.int16)
    want = np.asarray(sp.sgm_aggregate_pallas(jnp.asarray(vol), 32, 384, 8, jnp.asarray(img),
                                              True, 96, interpret=True))
    got = sgm_cuda.sgm_aggregate_hwd(torch.from_numpy(vol), 32, 384, 8, torch.from_numpy(img),
                                     True, 96)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        sgm_cuda.sgm_aggregate_hwd(torch.from_numpy(vol).to(torch.int8))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("diagonals", [False, True])
def test_k11_pair_bit_exact_to_pallas(data, diagonals, axis):
    """The forward and backward groups of one axis, as _sweep_hdw_bidir
    returns them (the horizontal pair on the transposed volume)."""
    vol, img = data
    p2_y, p2_x = _maps(data, True)
    v, p2 = (vol, p2_y) if axis == 0 else (np.ascontiguousarray(vol.swapaxes(0, 1)), p2_x.T)
    want = sp._sweep_hdw_bidir(_hdw(v), jnp.asarray(p2.numpy()), P1, diagonals, True)
    got = sgm_cuda.sweep_pair(torch.from_numpy(v), p2.contiguous(), P1, diagonals)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _hwd(w_))


@pytest.mark.parametrize("num_paths", [4, 8])
def test_k12_bit_exact_to_pallas(data, num_paths):
    """((lr + rl) + down) + up, fused at y = 0 and y = H-1 with 8 paths."""
    vol, img = data
    want = sp.sgm_extract_fused_hdw(_hdw(vol), None, P1, P2, num_paths, jnp.asarray(img), True,
                                    P2_MIN, True, 0.95, 1.5, interpret=True)
    p2_y, p2_x = _maps(data, True)
    got = sgm_cuda.sgm_extract_fused(torch.from_numpy(vol), p2_y, p2_x, P1, num_paths, True,
                                     0.95, 1.5)
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_wdh_order_bit_exact_to_pallas(data, num_paths):
    """((down + up) + lr) + rl, then extraction, as sgm_extract_fused_wdh."""
    vol, img = data
    want = sp.sgm_extract_fused_wdh(_hdw(vol), None, P1, P2, num_paths, jnp.asarray(img), True,
                                    P2_MIN, True, 0.0, 0.0, interpret=True)
    p2_y, p2_x = _maps(data, True)
    total = sgm_cuda.sgm_aggregate_float(torch.from_numpy(vol), p2_y, p2_x, P1, num_paths,
                                         order="wdh")
    got = extract_disparity_maps(total, True, 0.0, 0.0)
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_orders_differ_only_in_rounding(data):
    """The four orders sum the same paths: equal to float rounding, and the
    fused rows really change some values with 8 paths."""
    vol, _ = data
    p2_y, p2_x = _maps(data, True)
    sums = {o: port.aggregate_paths_float(torch.from_numpy(vol), p2_y, p2_x, P1, 8, order=o)
            for o in port.ORDERS}
    for o in port.ORDERS:
        np.testing.assert_allclose(sums[o].numpy(), sums["k10"].numpy(), rtol=1e-6)
    assert not torch.equal(sums["k7"][-1], sums["k10"][-1])
    assert torch.equal(sums["k7"][:-1], sums["k10"][:-1])


def _round_f32(q: Fraction) -> np.float32:
    """Nearest float32 to the exact rational q, ties to even."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_fma3_rounds_once():
    """fma3 is 3c + acc rounded once, halfway cases included: a double sum
    that lands on a float32 halfway point must go the way of the exact sum."""
    r = np.random.default_rng(1)
    c = r.uniform(0, 100, 400).astype(np.float32)
    acc = r.uniform(0, 3000, 400).astype(np.float32)
    # halfway cases: 3c exactly halfway between two floats near 3 (ulp
    # 2**-22), and an acc too small for the double sum to keep
    c[:20] = np.float32(1.0 + 2.0 ** -23)  # 3c = 3 + 1.5 ulp: the exact sum rounds down
    acc[:20] = np.float32(-(2.0 ** -60))
    c[20:50] = np.float32(1.0 + 3 * 2.0 ** -23)  # 3c = 3 + 4.5 ulp
    acc[20:40] = np.float32(2.0 ** -60)  # rounds up, away from the even neighbour
    acc[40:50] = np.float32(-(2.0 ** -60))
    acc[50:60] = np.float32(2 ** 40)  # exponents far apart: the double sum rounds
    c[50:60] = r.uniform(0, 1e-4, 10).astype(np.float32)
    got = port.fma3(torch.from_numpy(c), torch.from_numpy(acc)).numpy()
    want = np.array([_round_f32(3 * Fraction(float(a)) + Fraction(float(b)))
                     for a, b in zip(c, acc)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (torch.from_numpy(acc).double() + 3.0 * torch.from_numpy(c).double()).float().numpy()
    assert (naive != want).any()  # the halfway cases defeat a plain double sum


# ---- K6: standalone extraction ---------------------------------------------------------


def _volume(dtype):
    """A volume of the dtype holding the ties and borders extraction must break alike."""
    r = np.random.default_rng(11)
    if dtype == "float32":
        a = r.uniform(10.0, 300.0, (H, 20, 12)).astype(np.float32)
        big = 2e9  # above BIG = 1e9: out-of-image right-view candidates win there
    else:
        hi = 120 if dtype == "int8" else 400
        a = r.integers(20, hi, (H, 20, 12)).astype(dtype)
        big = None if dtype == "int8" else 16500
    a[0, :, 3] = a[0, :, 9] = 10  # exact tie far apart
    a[1, :, 0] = 5  # winner at d = 0
    a[2, :, -1] = 5  # winner at d = D-1
    a[3, :, 5] = a[3, :, 6] = 7  # adjacent tie
    a[4] = 100  # flat: every d ties
    if big is not None:
        a[5] = big
    return a


@pytest.mark.parametrize("uniqueness,lr", [(0.0, 0.0), (0.95, 1.5)])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int16"])
def test_k6_maps_bit_exact_to_pallas(dtype, uniqueness, lr):
    a = _volume(dtype)
    want = extract_maps_hdw(_hdw(a), True, uniqueness, lr, interpret=True)
    got = extract_disparity_maps(torch.from_numpy(a), True, uniqueness, lr)
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("dtype,subpixel", [("float32", True), ("int8", False)])
def test_k6_disparity_with_mask_bit_exact_to_pallas(dtype, subpixel):
    a = _volume(dtype)
    mask = np.random.default_rng(3).uniform(size=a.shape[:2]) > 0.3
    want = extract_disparity_hdw(_hdw(a), subpixel, 0.95, 1.5, jnp.asarray(mask), interpret=True)
    got = extract_disparity(torch.from_numpy(a), subpixel, 0.95, 1.5, torch.from_numpy(mask))
    for name in ("disparity", "cost", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), atol=1e-6)


def test_wrappers_run_the_plain_twins_on_cpu(data, launched):
    vol, _ = data
    p2_y, p2_x = _maps(data, True)
    v = torch.from_numpy(vol)
    assert torch.equal(sgm_cuda.sgm_aggregate_float(v, p2_y, p2_x, P1),
                       port.aggregate_paths_float(v, p2_y, p2_x, P1))
    extract_disparity_maps(v, True, 0.95, 1.5)
    sgm_cuda.sgm_aggregate_hwd(v, P1, P2, 8)
    sgm_cuda.sweep_pair(v, p2_y, P1)
    sgm_cuda.sgm_extract_fused(v, p2_y, p2_x, P1)
    assert launched == []


def test_bad_orders_and_sweeps_are_refused(data):
    vol, _ = data
    p2_y, p2_x = _maps(data, True)
    v = torch.from_numpy(vol)
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate_float(v, p2_y, p2_x, P1, order="k8")
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate_float(v, p2_y, p2_x, P1, sweeps=("down",), order="wdh")
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate_float(v, p2_y, p2_x, P1, sweeps=("left",))
    with pytest.raises(TypeError):  # float costs go through sgm_aggregate_float
        sgm_cuda.sgm_aggregate_paths(v, p2_y, p2_x, P1)


# ---- routing: every float route through the kernel wrappers -------------------------------


def _record(monkeypatch, module, names):
    """Replace each wrapper `name` in `module` by one that records (name, volume
    dtype) and runs the wrapper's plain twin (its backend argument -> "torch")."""
    calls = []
    for name in names:
        real = getattr(module, name)

        def fake(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[0].dtype))
            args = tuple("torch" if isinstance(a, str) and a in ("auto", "cuda") else a
                         for a in args)
            kw = {k: "torch" if k == "backend" else v for k, v in kw.items()}
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, fake)
    return calls


def test_two_view_float_route_reaches_k1_k7_k6(monkeypatch):
    from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
    from stereovisionarray_tpu_torch.models import two_view as tv

    r = np.random.default_rng(4)
    base = r.uniform(0, 255, (10, 40)).astype(np.float32)
    left, right = torch.from_numpy(base[:, :32].copy()), torch.from_numpy(base[:, 8:].copy())
    cc, sc = CostConfig(num_disparities=8, census_window=(3, 5), dtype="float32"), SGMConfig()
    want = tv.two_view_disparity(left, right, cc, sc)
    monkeypatch.setattr(tv, "resolve_backend", lambda t, b="auto": "cuda")
    calls = _record(monkeypatch, tv, ("fused_cost_volume_cuda", "sgm_aggregate_paths",
                                      "sgm_aggregate_float", "extract_disparity", "extract_maps"))
    got = tv.two_view_disparity(left, right, cc, sc)
    assert calls == [("fused_cost_volume_cuda", torch.float32),
                     ("sgm_aggregate_float", torch.float32),
                     ("extract_disparity", torch.float32)]
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", ["no_sgm", "zncc_float"])
def test_volume_to_maps_float_routes_reach_k7_k6(monkeypatch, case):
    """sgm_cfg=None: raw WTA through K6 on the quantized volume. ZNCC under
    the default SGM (penalties too large for the int16 scale): float K7 in
    the wdh order, then K6. Neither raises any more on a CUDA tensor."""
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.models import plane_sweep as ps

    cfg = EngineConfig().override(**{"plane_sweep.cost": "zncc" if case == "zncc_float"
                                     else "census"})
    r = np.random.default_rng(5)
    vol = torch.from_numpy(r.uniform(0, 2.0 if case == "zncc_float" else 24.0,
                                     (6, 9, 8)).astype(np.float32))
    img = torch.from_numpy(r.uniform(0, 255, (6, 9)).astype(np.float32))
    sgm = None if case == "no_sgm" else cfg.sgm
    want = ps._volume_to_maps(vol, img, cfg.plane_sweep, sgm, "auto")
    monkeypatch.setattr(ps, "resolve_backend", lambda t, b="auto": "cuda")
    calls = _record(monkeypatch, ps, ("sgm_aggregate_paths", "sgm_aggregate_float",
                                      "extract_maps", "extract_disparity_maps"))
    got = ps._volume_to_maps(vol, img, cfg.plane_sweep, sgm, "auto")
    if case == "no_sgm":
        assert calls == [("extract_disparity_maps", torch.int8)]
    else:
        assert calls == [("sgm_aggregate_float", torch.float32),
                         ("extract_disparity_maps", torch.float32)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_xla_backend_launches_no_kernel(monkeypatch):
    """backend="xla" takes the XLA twins: no kernel wrapper is called on the
    two-view path, and every wrapper treats "xla" as "torch"."""
    from stereovisionarray_tpu_torch.backend import resolve_backend
    from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
    from stereovisionarray_tpu_torch.models import two_view as tv

    assert resolve_backend(torch.zeros(1), "xla") == "xla"
    calls = _record(monkeypatch, tv, ("fused_cost_volume_cuda", "sgm_aggregate_paths",
                                      "sgm_aggregate_float", "extract_disparity", "extract_maps"))
    r = np.random.default_rng(6)
    img = torch.from_numpy(r.uniform(0, 255, (8, 24)).astype(np.float32))
    out = tv.two_view_disparity(img, img, CostConfig(num_disparities=4, census_window=(3, 3),
                                                     dtype="int16"), SGMConfig(), backend="xla")
    assert calls == [] and out.cost.dtype == torch.float32  # integer dtypes compute in float
    vol = torch.from_numpy(r.uniform(0, 9, (5, 6, 4)).astype(np.float32))
    assert torch.equal(extract_disparity_maps(vol, backend="xla").cost,
                       extract_disparity_maps(vol, backend="torch").cost)
