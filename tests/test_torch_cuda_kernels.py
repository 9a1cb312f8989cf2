"""Each CUDA kernel of the port against its plain PyTorch twin on the same
CUDA tensors, bit-exact, across the configurations the kernels branch on:
every lanes-per-warp width of the SGM scans (D up to 32, 64, 128, 256),
census codes of one to four 64-bit words, int8 and int16 costs, 4 and 8 paths,
and images narrower than a tile or than the disparity range; the plane sweep
K8 over 1 to 24 sources, every fusion (plain mean, valid mean, top-k from 1
to S-1), patch 3 to 17, odd shapes and 1 to 256 planes; K2/K3 and K4 at
D=128 on a quantized plane volume; the hat sampler K9 over tap ranges from
one tap to 99, batches, both axes, the aux table, ragged shapes and t far
outside the range, its 128-bit path and its scalar path (W % 4 != 0,
misaligned views), and its 2-D form against two K9 launches; the float
kernels: K1's float32 store, the float SGM scans and ordered combine (K7,
every order and sweep subset, 4 and 8 paths, every lanes-per-warp width, and
the K10-K12 entry points over them), and the extraction K6 over float32,
int8 and int16 volumes with uniqueness and LR; the extraction kernel with
the LR check fused (K4 with K5's check) over the three dtypes and every
cluster width, K6 with LR in one launch, and the integer two-view path with
no standalone K5.

Needs a CUDA device and nvcc; without one every test skips. The GPU machine
has no JAX, so run these without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
from stereovisionarray_tpu_torch.models.two_view import two_view_disparity
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    MAX_LR_WIDTH,
    extract_disparity,
    extract_disparity_maps,
    extract_maps,
    lr_gather,
)
from stereovisionarray_tpu_torch.ops.hatsample import MAX_ROW_BYTES, hat_sample, hat_sample_2d
from stereovisionarray_tpu_torch.ops.sgm import ORDERS, p2_maps
from stereovisionarray_tpu_torch.ops.sgm_cuda import (
    sgm_aggregate_float,
    sgm_aggregate_hwd,
    sgm_aggregate_paths,
    sgm_extract_fused,
    sweep_pair,
)
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return np.random.default_rng(0)


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _same(got, want):
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for a, b in pairs:
        if a is None and b is None:  # a map left out on both routes
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("h,w,D,window,bt_weight,dtype", [
    (17, 50, 3, (3, 3), 0.25, "int16"),  # W < one tile
    (33, 64, 12, (5, 5), 0.0, "int8"),
    (20, 129, 64, (7, 9), 0.25, "int8"),  # 62 bits: one word; ragged last tile
    (9, 70, 100, (11, 13), 0.25, "int16"),  # 142 bits: three words; D > W
    (6, 300, 256, (15, 17), 0.5, "int16"),  # 254 bits: four words
    (1, 1, 8, (7, 9), 0.25, "int16"),  # one pixel
    (20, 129, 64, (7, 9), 0.25, "float32"),  # float32 store: unscaled, no rounding
    (9, 70, 100, (11, 13), 0.3, "float32"),  # out-of-image cost in float32 arithmetic
    (17, 50, 3, (3, 3), 0.0, "float32"),
])
def test_cost_volume_kernel(rng, h, w, D, window, bt_weight, dtype):
    img = np.floor(rng.uniform(0, 256, (h, w + 8))).astype(np.float32)
    left, right = _cuda(img[:, :w]), _cuda(img[:, 8:])
    call = lambda b: fused_cost_volume_cuda(left, right, D, window, bt_weight, 32.0, dtype, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("dtype,hi", [("int8", 71), ("int16", 300)])
@pytest.mark.parametrize("h,w,D", [(13, 37, 3), (11, 40, 32), (9, 21, 33), (16, 16, 64),
                                   (7, 30, 100), (5, 9, 129), (6, 11, 256), (1, 25, 20),
                                   (24, 1, 20)])
def test_sgm_paths_kernel(rng, h, w, D, dtype, hi, num_paths):
    vol = _cuda(rng.integers(0, hi, (h, w, D)).astype(dtype))
    image = _cuda(np.floor(rng.uniform(0, 256, (h, w))).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 384, torch.int16, vol.device, image, True, 96)
    call = lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, 32, num_paths, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("uniqueness", [0.0, 0.95])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("h,w,D", [(12, 40, 16), (5, 7, 48), (3, 300, 3), (4, 130, 256)])
def test_extract_and_lr_gather_kernels(rng, h, w, D, subpixel, uniqueness):
    a = rng.integers(50, 400, (h, w, D)).astype(np.int16)
    a[0, :, 1] = a[0, :, D - 1] = 10  # exact tie: smallest d wins
    a[1 % h, :, D - 1] = 5  # winner at the last disparity
    a[2 % h] = 16500  # above BIG: out-of-image right-view candidates win
    total = _cuda(a)
    call = lambda b: extract_maps(total, subpixel, uniqueness, b)  # noqa: E731
    maps = call("cuda")
    _same(maps, call("torch"))
    disp_l = maps.disparity.clone()
    disp_l[:, ::3] = torch.floor(disp_l[:, ::3]) + 0.5  # rounding ties, half to even
    gather = lambda b: lr_gather(disp_l, maps.disparity_right, D, b)  # noqa: E731
    _same(gather("cuda"), gather("torch"))


@pytest.mark.parametrize("S,topk,valid_mean,patch,h,w,D", [
    (1, None, False, 5, 33, 47, 7),
    (1, None, True, 3, 17, 40, 1),
    (4, None, False, 5, 37, 65, 128),
    (4, 1, False, 7, 29, 33, 7),
    (4, 3, False, 9, 21, 70, 7),
    (4, None, False, 17, 20, 30, 7),  # 288 census bits: five 64-bit words
    (8, 6, False, 5, 40, 41, 128),
    (8, None, True, 3, 31, 97, 7),
    (9, None, False, 5, 35, 63, 7),  # the reference kernel's sentinel-pad case
    (9, 8, False, 7, 19, 35, 256),
    (24, 6, False, 5, 45, 61, 128),
    (24, 1, False, 3, 23, 37, 7),
    (24, 23, False, 9, 27, 29, 7),
    (24, None, True, 5, 41, 53, 256),
    (24, None, False, 7, 13, 100, 1),
])
def test_plane_sweep_kernel(rng, S, topk, valid_mean, patch, h, w, D):
    """K8 on float (non-integer) images, with fractional, integer, zero and
    out-of-image shifts."""
    ref = _cuda(rng.uniform(0, 255, (h, w)).astype(np.float32))
    src = _cuda(rng.uniform(0, 255, (S, h, w)).astype(np.float32))
    sh = rng.uniform(-12, 12, (D, S, 2)).astype(np.float32)
    sh[::3, :, 1] = 0.0  # motion along x only
    sh[1::4] = np.round(sh[1::4])  # integer shifts: zero lerp weights
    sh[-1, 0] = (w + 5.0, -h - 3.5)  # a source entirely out of view
    shifts = _cuda(sh)
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, valid_mean, topk, b)  # noqa: E731
    got = call("cuda")
    _same(got, call("torch"))
    assert got[0].shape == (h, w, D) and got[1].dtype == torch.int32


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("patch,dtype", [(5, torch.int8), (7, torch.int16)])
def test_sgm_and_extract_kernels_on_a_plane_volume(rng, patch, dtype, num_paths):
    """K2/K3 and K4 at D=128 on a quantized plane-sweep volume, as the array
    path feeds them."""
    h, w, S, D = 45, 70, 4, 128
    ref = _cuda(rng.uniform(0, 255, (h, w)).astype(np.float32))
    src = _cuda(rng.uniform(0, 255, (S, h, w)).astype(np.float32))
    shifts = _cuda(rng.uniform(-6, 6, (D, S, 2)).astype(np.float32))
    vol, _ = plane_sweep_census(ref, src, shifts, patch)
    q = torch.round(vol * 4).to(dtype)
    p2_y, p2_x = p2_maps((h, w), 384, torch.int16, q.device, ref, True, 96)
    paths = lambda b: sgm_aggregate_paths(q, p2_y, p2_x, 32, num_paths, b)  # noqa: E731
    total = paths("cuda")
    _same(total, paths("torch"))
    _same(extract_maps(total, True, 0.0, "cuda"), extract_maps(total, True, 0.0, "torch"))


@pytest.mark.parametrize("k0,k1", [(-36, 36), (0, 23), (-49, 49), (-3, -3), (2, 9), (-12, 3)])
@pytest.mark.parametrize("shape,axis,aux", [((540, 768), -1, True), ((33, 17), -1, False),
                                            ((4, 45, 61), -2, False), ((4, 45, 61), -1, False),
                                            ((3, 1, 130), -1, True), ((2, 70, 1), -2, False)])
def test_hat_sample_kernel(rng, shape, axis, aux, k0, k1):
    """K9 on float maps: t inside the range, on its integer taps, at its
    edges (partial weights) and far outside it."""
    values = _cuda(rng.uniform(0, 255, shape).astype(np.float32))
    t = rng.uniform(k0 - 3.0, k1 + 3.0, shape).astype(np.float32)
    flat = t.reshape(-1)
    flat[::7] = np.round(flat[::7])  # integer taps: one weight of exactly 1
    flat[1::11] = k0 - 40.0  # far outside: every weight 0
    flat[2::13] = k1 + 0.5  # half a tap past the range: weight 0.5
    tt = _cuda(t)
    a = _cuda(rng.uniform(-30, 30, shape[-1]).astype(np.float32)) if aux else None
    call = lambda b: hat_sample(values, tt, k0, k1, aux=a, axis=axis, backend=b)  # noqa: E731
    got = call("cuda")
    _same(got, call("torch"))
    assert (got[0] if aux else got).shape == tuple(shape)


def _float_volume(rng, h, w, D):
    vol = rng.uniform(0.0, 60.0, (h, w, D)).astype(np.float32)
    vol[0, :, :] = np.round(vol[0])  # integer costs: exact ties in the sums
    return _cuda(vol)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("h,w,D", [(13, 37, 3), (11, 40, 32), (9, 21, 33), (16, 16, 64),
                                   (7, 30, 100), (6, 11, 256), (1, 25, 20), (24, 1, 20)])
def test_float_sgm_kernel(rng, h, w, D, num_paths, order):
    """K7: the float scans and the ordered combine, every order."""
    vol = _float_volume(rng, h, w, D)
    image = _cuda(rng.uniform(0, 256, (h, w)).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 32.0, torch.float32, vol.device, image, True, 8.0)
    call = lambda b: sgm_aggregate_float(vol, p2_y, p2_x, 4.0, num_paths, order=order,  # noqa: E731
                                         backend=b)
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("sweeps", [("down",), ("up",), ("lr",), ("rl",), ("down", "up"),
                                    ("lr", "rl"), ("up", "rl"), ("down", "up", "lr")])
def test_float_sgm_kernel_sweep_subsets(rng, sweeps):
    vol = _float_volume(rng, 19, 45, 48)
    p2 = _cuda(rng.uniform(8.0, 32.0, (19, 45)).astype(np.float32))
    call = lambda b: sgm_aggregate_float(vol, p2, p2, 4.0, 8, sweeps, "k7", b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("diagonals", [False, True])
def test_k10_k11_k12_entry_points(rng, diagonals):
    h, w, D = 21, 34, 40
    num_paths = 8 if diagonals else 4
    vol = _float_volume(rng, h, w, D)
    image = _cuda(rng.uniform(0, 256, (h, w)).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 32.0, torch.float32, vol.device, image, True, 8.0)
    _same(sgm_aggregate_hwd(vol, 4.0, 32.0, num_paths, image, True, 8.0, "cuda"),
          sgm_aggregate_hwd(vol, 4.0, 32.0, num_paths, image, True, 8.0, "torch"))
    q = torch.round(vol * 4).to(torch.int16)
    _same(sgm_aggregate_hwd(q, 16, 128, num_paths, image, True, 32, "cuda"),
          sgm_aggregate_hwd(q, 16, 128, num_paths, image, True, 32, "torch"))
    _same(sweep_pair(vol, p2_y, 4.0, diagonals, "cuda"), sweep_pair(vol, p2_y, 4.0, diagonals,
                                                                     "torch"))
    vt, pt = vol.transpose(0, 1).contiguous(), p2_x.t().contiguous()
    _same(sweep_pair(vt, pt, 4.0, diagonals, "cuda"), sweep_pair(vt, pt, 4.0, diagonals, "torch"))
    _same(sgm_extract_fused(vol, p2_y, p2_x, 4.0, num_paths, True, 0.95, 1.5, "cuda"),
          sgm_extract_fused(vol, p2_y, p2_x, 4.0, num_paths, True, 0.95, 1.5, "torch"))
    qy, qx = p2_maps((h, w), 128, torch.int16, vol.device, image, True, 32)
    _same(sgm_extract_fused(q, qy, qx, 16, num_paths, True, 0.95, 1.5, "cuda"),
          sgm_extract_fused(q, qy, qx, 16, num_paths, True, 0.95, 1.5, "torch"))


def test_k10_k12_count_only_their_own_launches(rng):
    """K10 and K12 launch the K7/K6 kernels through their own wrappers: each
    call adds one to its own count and none to K7's or K6's."""
    h, w, D = 9, 20, 16
    vol = _float_volume(rng, h, w, D)
    p2 = _cuda(rng.uniform(8.0, 32.0, (h, w)).astype(np.float32))
    fns = (sgm_aggregate_float, sgm_aggregate_hwd, sgm_extract_fused, extract_disparity_maps)
    for fn in fns:
        fn.launches = 0
    sgm_aggregate_hwd(vol, backend="cuda")
    sgm_extract_fused(vol, p2, p2, 4.0, 8, True, 0.95, 1.5, "cuda")
    assert [fn.launches for fn in fns] == [0, 1, 1, 0]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16"])
@pytest.mark.parametrize("h,w,D", [(12, 40, 16), (5, 7, 48), (3, 300, 3), (4, 130, 256)])
def test_standalone_extraction_kernel(rng, h, w, D, dtype):
    """K6 over raw and aggregated volumes of every dtype, with ties, winners at
    both ends, costs above BIG, uniqueness, the LR check and a mask."""
    if dtype == "float32":
        a = rng.uniform(10.0, 400.0, (h, w, D)).astype(np.float32)
        big = 2e9
    else:
        a = rng.integers(20, 120 if dtype == "int8" else 400, (h, w, D)).astype(dtype)
        big = None if dtype == "int8" else 16500
    a[0, :, 1] = a[0, :, D - 1] = 10  # exact tie: smallest d wins
    a[1 % h, :, D - 1] = 5
    if big is not None:
        a[2 % h] = big
    vol = _cuda(a)
    mask = _cuda(rng.uniform(size=(h, w)) > 0.3)
    for subpixel, uniqueness, lr in ((True, 0.0, 0.0), (True, 0.95, 1.5), (False, 0.95, 1.25),
                                     (True, 0.0, 1.1)):
        _same(extract_disparity_maps(vol, subpixel, uniqueness, lr, "cuda"),
              extract_disparity_maps(vol, subpixel, uniqueness, lr, "torch"))
    _same(extract_disparity(vol, True, 0.95, 1.5, mask, "cuda"),
          extract_disparity(vol, True, 0.95, 1.5, mask, "torch"))


def _volume(rng, h, w, D, dtype):
    """An (H, W, D) volume with exact ties, winners at both ends and, for
    int16 and float32, costs above BIG (out-of-image candidates win)."""
    if dtype == "float32":
        a = rng.uniform(10.0, 400.0, (h, w, D)).astype(np.float32)
        big = 2e9
    else:
        a = rng.integers(20, 120 if dtype == "int8" else 400, (h, w, D)).astype(dtype)
        big = None if dtype == "int8" else 16500
    a[0, :, 1] = a[0, :, D - 1] = 10
    a[1 % h, :, D - 1] = 5
    if big is not None:
        a[2 % h, : w // 2] = big
    return _cuda(a)


@pytest.mark.parametrize("lr", [0.0, 1.5])
@pytest.mark.parametrize("dtype", ["int8", "int16", "float32"])
@pytest.mark.parametrize("h,w,D", [(6, 21, 8), (5, 10, 16), (7, 13, 3), (4, 130, 64),
                                   (9, 768, 64), (3, 1100, 40), (2, 2500, 9)])
def test_fused_extraction_kernel(rng, h, w, D, dtype, lr):
    """K4 with K5's LR check in the same launch, against the plain route:
    rows of 1 to 8 CTAs (a cluster), CTAs of more columns than threads, with
    and without the right map, with and without subpixel."""
    vol = _volume(rng, h, w, D, dtype)
    for subpixel, right in ((True, False), (True, True), (False, False)):
        call = lambda b: extract_maps(vol, subpixel, 0.95, b, lr_max_diff=lr, right=right)  # noqa: E731
        got = call("cuda")
        _same(got, call("torch"))
        assert (got.disparity_right is None) != right


@pytest.fixture
def launched(monkeypatch):
    """The C entry points launched through _native, in order."""
    names = []
    real = _native.launch

    def spy(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(_native, "launch", spy)
    return names


def test_k6_with_lr_is_one_launch(rng, launched):
    vol = _volume(rng, 12, 40, 16, "float32")
    extract_disparity_maps.launches = lr_gather.launches = lr_gather.fused_launches = 0
    got = extract_disparity_maps(vol, True, 0.95, 1.5, "cuda")
    assert launched == ["svt_extract_maps"]
    assert (extract_disparity_maps.launches, lr_gather.fused_launches, lr_gather.launches) == (
        1, 1, 0)
    _same(got, extract_disparity_maps(vol, True, 0.95, 1.5, "torch"))


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_integer_two_view_runs_no_standalone_lr_gather(rng, launched, dtype):
    img = np.floor(rng.uniform(0, 256, (24, 72))).astype(np.float32)
    left, right = _cuda(img[:, :64]), _cuda(img[:, 8:])
    cc = CostConfig(num_disparities=16, census_window=(5, 5), dtype=dtype)
    sc = SGMConfig(uniqueness=0.95, lr_max_diff=1.5)
    extract_maps.launches = lr_gather.launches = lr_gather.fused_launches = 0
    got = two_view_disparity(left, right, cc, sc)
    assert launched.count("svt_extract_maps") == 1 and "svt_lr_gather" not in launched
    assert (extract_maps.launches, lr_gather.fused_launches, lr_gather.launches) == (1, 1, 0)
    want = two_view_disparity(left, right, cc, sc, backend="torch")
    for field in ("disparity", "valid", "cost", "confidence"):
        _same(getattr(got, field), getattr(want, field))


def test_fused_lr_refuses_rows_past_the_cluster(rng):
    vol = torch.zeros((1, MAX_LR_WIDTH + 1, 3), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        extract_maps(vol, lr_max_diff=1.0, backend="cuda")
    extract_maps(vol[:, :MAX_LR_WIDTH].contiguous(), lr_max_diff=1.0, backend="cuda")


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("shape", [(7, 64), (5, 37), (3, 9, 4), (2, 6, 1), (1, 3)])
def test_hat_sample_vector_and_scalar_paths(rng, shape, aux, offset):
    """K9's 128-bit path (W % 4 == 0, 16-byte aligned t) and its scalar path
    (W % 4 != 0, or t a view `offset` floats into its storage)."""
    n = int(np.prod(shape))
    values = _cuda(rng.uniform(0, 255, shape).astype(np.float32))
    storage = _cuda(rng.uniform(-6.0, 6.0, n + offset).astype(np.float32))
    t = storage[offset:].view(shape)
    assert t.is_contiguous() and (t.data_ptr() % 16 == 0) == (offset == 0)
    a = _cuda(rng.uniform(-30, 30, shape[-1]).astype(np.float32)) if aux else None
    for axis in (-1, -2) if not aux else (-1,):
        call = lambda b: hat_sample(values, t, -4, 4, aux=a, axis=axis, backend=b)  # noqa: E731
        _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("pad", [1, 9, 36])
@pytest.mark.parametrize("shape", [(4, 45, 61), (4, 270, 360), (33, 17), (2, 7, 1),
                                   (1, 3, 13000)])
def test_hat_sample_2d_kernel(rng, shape, pad):
    """The 2-D form against two K9 launches (along rows, then along columns)
    and against its plain twin; W = 13000 opts into shared memory past 48 KB."""
    values = _cuda(rng.uniform(0, 255, shape).astype(np.float32))
    t_rows, t_cols = (_cuda(rng.uniform(-pad - 3.0, pad + 3.0, shape).astype(np.float32))
                      for _ in range(2))
    got = hat_sample_2d(values, t_rows, t_cols, -pad, pad, "cuda")
    two = hat_sample(hat_sample(values, t_rows, -pad, pad, axis=-2, backend="cuda"), t_cols,
                     -pad, pad, backend="cuda")
    _same(got, two)
    _same(got, hat_sample_2d(values, t_rows, t_cols, -pad, pad, "torch"))


def test_hat_sample_2d_counts_and_refuses_wide_rows(rng):
    v = _cuda(rng.uniform(0, 255, (2, 5, 9)).astype(np.float32))
    hat_sample.launches = hat_sample_2d.launches = 0
    hat_sample_2d(v, v, v, -2, 2, "cuda")
    assert (hat_sample.launches, hat_sample_2d.launches) == (0, 1)
    wide = torch.zeros((1, 2, MAX_ROW_BYTES // 4 + 1), device="cuda")
    with pytest.raises(ValueError, match="at most"):
        hat_sample_2d(wide, wide, wide, -1, 1, "cuda")


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_adaptive_p2_maps_do_not_wait_for_the_device(rng, dtype):
    """The edge-adaptive P2 maps of the main path enqueue their work without
    a host-device copy (each such copy waits for the stream): while a spin
    runs on the card they return, and equal the maps computed with the two
    constants as CUDA tensors."""
    img = _cuda(np.floor(rng.uniform(0, 256, (40, 64))).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 28)  # ~0.1 s of device time
    spinning = torch.cuda.Event()
    spinning.record()
    p2_y, p2_x = p2_maps((40, 64), 96.0, dtype, img.device, img, True, 24.0)
    assert not spinning.query()  # the host never waited for the spin
    for axis, got in ((0, p2_y), (1, p2_x)):
        g = torch.diff(img, dim=axis, prepend=img.narrow(axis, 0, 1)).abs()
        want = torch.maximum(torch.tensor(96.0, device="cuda") / (1.0 + 0.5 * g),
                             torch.tensor(24.0, device="cuda"))
        _same(got, torch.round(want).to(dtype) if dtype == torch.int16 else want)
