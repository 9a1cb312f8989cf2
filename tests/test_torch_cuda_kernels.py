"""Each CUDA kernel of the port against its plain PyTorch twin on the same
CUDA tensors, bit-exact, across the configurations the kernels branch on:
every lanes-per-warp width of the SGM scans (D up to 32, 64, 128, 256),
census codes of one to four 64-bit words, int8 and int16 costs, 4 and 8 paths,
and images narrower than a tile or than the disparity range; the plane sweep
K8 over 1 to 24 sources, every fusion (plain mean, valid mean, top-k from 1
to S-1; every slot count of the specialised kernel at patch 3, 5 and 7),
patch 3 to 17, odd shapes and 1 to 256 planes, shapes one either side of
the specialised kernel's strip and block, the 5x5 rig's own CROSS and
to_center shift tables at 270x360x128, and images of -0.0, ties, negative
values, infinities and NaN (its census bit is the sign of a float
difference); K2/K3 and K4 at
D=128 on a quantized plane volume; the hat sampler K9 over tap ranges from
one tap to 99, batches, both axes, the aux table, ragged shapes and t far
outside the range, its 128-bit path and its scalar path (W % 4 != 0,
misaligned views), and its 2-D form against two K9 launches; the float
kernels: K1's float32 store, the float SGM scans and ordered combine (K7,
every order and sweep subset, 4 and 8 paths, every lanes-per-warp width, and
the K10-K12 entry points over them; its strip route at the float paths'
shapes, with an image narrower than its strip height, its generic form where
the plan refuses, the strip entry point's refusals, and that it does not
wait for the card), and the extraction K6 over float32,
int8 and int16 volumes with uniqueness and LR; the extraction kernel with
the LR check fused (K4 with K5's check) over the three dtypes and every
cluster width, K6 with LR in one launch, and the integer two-view path with
no standalone K5; the extraction's tiled form at the main paths' shapes
(the array's 270x360x128 without the right view), on its narrower tiles and
in its element staging (an offset view, D = 97), on wrapped int16 totals,
its split form (540x768x256 and KITTI's 375x1242x256 int16 with LR; W < D,
tiles that do not divide a CTA's columns, windows over 3 and 4 CTAs, int8
at D = 384, element staging), its generic form (float32, D = 256, LR), and
the entry point's refusal of a form, tile or stride it does not take; the cost
volume's tiled form at the main paths' shapes (C = 256, 128, 64; 8- and
16-byte runs; the cascade's 5x7 census; images not 16-byte aligned), its
generic form (47 bytes a pixel), and the entry point's refusals; for the
served capture path, that the array pipeline with the rig's tensors on the
card, the temporal filter and the face ROI's stages do not wait for the card;
for SfM, that calibrate_array makes no synchronizing call but its final copy,
gives bit-identical runs and ignores TF32, and that the calibrated rig's
depth (no synchronizing call; behind a spin on two views) and a rectified
verged pair equal their plain routes; for the command line, that `two-view`
and `depth` with --device cuda write the artifacts --device cpu writes.
Each kernel also runs at every shape a path gives it (``torch_records``:
the bench, entry, golden, cascade and array shapes, and the odd parity
shapes 541x766 and 271x361). Which entry points a call launches is seen
by a spy on ``_native.launch`` (``torch_launches.launched``); the paths,
goldens, records and the CLI on the card are ``test_torch_card_paths.py``.

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
from stereovisionarray_tpu_torch.ops.cost_cuda import _tile_plan as cost_tile_plan
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    FORMS,
    MAX_LR_WIDTH,
    _tile_plan,
    extract_disparity,
    extract_disparity_maps,
    extract_maps,
    lr_gather,
)
from stereovisionarray_tpu_torch.ops.hatsample import MAX_ROW_BYTES, hat_sample, hat_sample_2d
from stereovisionarray_tpu_torch.ops.sgm import ALL_SWEEPS, ORDERS, p2_maps
from stereovisionarray_tpu_torch.ops.sgm_cuda import (
    _strip_plan,
    sgm_aggregate_float,
    sgm_aggregate_hwd,
    sgm_aggregate_paths,
    sgm_extract_fused,
    sweep_pair,
)
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census
from torch_launches import launched  # noqa: F401
from torch_records import EXTRACT_ROWS, K1_ROWS, extraction_call, extraction_volume, render_head

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
    # the tiled form: C = 256 at the bench width, every type
    (100, 768, 64, (7, 9), 0.25, "int8"),
    (100, 768, 64, (7, 9), 0.25, "int16"),
    (100, 768, 64, (7, 9), 0.25, "float32"),
    (256, 384, 64, (7, 9), 0.25, "int16"),  # the entry shape: C = 128
    (30, 768, 256, (7, 9), 0.25, "int8"),  # C = 64 at D = 256
    (135, 192, 64, (5, 7), 0.25, "int8"),  # the cascade's coarse pass
    (40, 768, 24, (7, 9), 0.25, "int8"),  # 8-byte runs: the cascade's fine pass
    (41, 766, 48, (7, 9), 0.0, "float32"),  # W % 4 != 0: staged a float at a time
    (20, 100, 47, (7, 9), 0.25, "int8"),  # 47 bytes a pixel: the generic form
    # every shape a path gives K1, the odd parity shape and the generic form's
    *((h, w, D, window, 0.25, dtype) for _, (h, w, D), window, dtype in K1_ROWS),
    (540, 768, 64, (7, 9), 0.0, "int8"),  # the bench shape without BT
])
def test_cost_volume_kernel(rng, h, w, D, window, bt_weight, dtype):
    img = np.floor(rng.uniform(0, 256, (h, w + 8))).astype(np.float32)
    left, right = _cuda(img[:, :w]), _cuda(img[:, 8:])
    call = lambda b: fused_cost_volume_cuda(left, right, D, window, bt_weight, 32.0, dtype, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("dtype", ["int8", "int16", "float32"])
def test_cost_volume_tiles_at_the_path_shapes(rng, monkeypatch, dtype):
    """The wrapper launches the tiled form with the plan's tile at the bench
    shape, also on images at an offset of one float (the scalar staging)."""
    h, w, D = 540, 768, 64
    base = torch.from_numpy(np.floor(rng.uniform(0, 256, 2 * h * w + 1)).astype(np.float32)).cuda()
    left, right = base[1:h * w + 1].view(h, w), base[h * w + 1:].view(h, w)
    tiles = []
    real = _native.launch
    monkeypatch.setattr(_native, "launch",
                        lambda name, *a: (tiles.append(a[14]), real(name, *a))[1])
    got = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, dtype)
    assert tiles == [cost_tile_plan(h, w, D, (7, 9), got.element_size()).tile] == [256]
    _same(got, fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, dtype, "torch"))


@pytest.mark.parametrize("tile,D", [(32, 64), (512, 64), (256, 47), (64, 30000)])
def test_cost_volume_entry_refuses(rng, tile, D):
    """svt_cost_volume refuses a tile it does not take, a pixel row of a size
    that is not a multiple of 8 bytes and a stage larger than shared memory."""
    left = _cuda(rng.uniform(0, 255, (8, 64)).astype(np.float32))
    out = torch.empty((8, 64, D), dtype=torch.int8, device=left.device)
    with pytest.raises(RuntimeError, match="svt_cost_volume"):
        _native.launch("svt_cost_volume", left.device, left.data_ptr(), left.data_ptr(),
                       out.data_ptr(), 1, 8, 64, D, 7, 9, 0.25, 32.0, 70.0, 1.0, tile)


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("dtype,hi", [("int8", 71), ("int16", 300)])
@pytest.mark.parametrize("h,w,D", [(13, 37, 3), (11, 40, 32), (9, 21, 33), (16, 16, 64),
                                   (7, 30, 100), (5, 9, 129), (6, 11, 256), (1, 25, 20),
                                   (24, 1, 20), (540, 768, 64), (541, 766, 48)])
def test_sgm_paths_kernel(rng, h, w, D, dtype, hi, num_paths):
    vol = _cuda(rng.integers(0, hi, (h, w, D)).astype(dtype))
    image = _cuda(np.floor(rng.uniform(0, 256, (h, w))).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 384, torch.int16, vol.device, image, True, 96)
    call = lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, 32, num_paths, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("uniqueness", [0.0, 0.95])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("h,w,D", [(12, 40, 16), (5, 7, 48), (3, 300, 3), (4, 130, 256),
                                   (540, 768, 64)])
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
    (4, None, False, 9, 270, 360, 128),  # the generic kernel at the array shape: patch 9
    (24, 9, False, 5, 270, 360, 128),  # and top-9 of 24
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
                                            ((3, 1, 130), -1, True), ((2, 70, 1), -2, False),
                                            # the two-view cascade's decode, the array
                                            # cascade's pre-warp along rows and columns
                                            ((540, 768), -1, False), ((4, 270, 360), -2, False),
                                            ((4, 270, 360), -1, False)])
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
@pytest.mark.parametrize("h,w,D", [(19, 45, 48), (540, 768, 64), (541, 766, 48)])
def test_float_sgm_kernel_sweep_subsets(rng, launched, h, w, D, sweeps):
    """A sweep subset takes K7's generic form: the path scans, then the
    ordered combine."""
    vol = _float_volume(rng, h, w, D)
    p2 = _cuda(rng.uniform(8.0, 32.0, (h, w)).astype(np.float32))
    call = lambda b: sgm_aggregate_float(vol, p2, p2, 4.0, 8, sweeps, "k7", b)  # noqa: E731
    got = call("cuda")
    assert launched == ["svt_sgm_paths_f32", "svt_sgm_combine_f32"]
    _same(got, call("torch"))


@pytest.mark.parametrize("diagonals", [False, True])
@pytest.mark.parametrize("h,w,D", [(21, 34, 40), (540, 768, 64)])
def test_k10_k11_k12_entry_points(rng, launched, h, w, D, diagonals):
    """K10 and K12 run K7's strip route (K2/K3 on int16), K12 then K6 with
    the LR check; K11 the generic form's scans and one combine a sweep."""
    num_paths = 8 if diagonals else 4
    vol = _float_volume(rng, h, w, D)
    image = _cuda(rng.uniform(0, 256, (h, w)).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 32.0, torch.float32, vol.device, image, True, 8.0)
    q = torch.round(vol * 4).to(torch.int16)
    qy, qx = p2_maps((h, w), 128, torch.int16, vol.device, image, True, 32)
    vt, pt = vol.transpose(0, 1).contiguous(), p2_x.t().contiguous()
    pair = ["svt_sgm_paths_f32", "svt_sgm_combine_f32", "svt_sgm_combine_f32"]
    for call, entries in (
            (lambda b: sgm_aggregate_hwd(vol, 4.0, 32.0, num_paths, image, True, 8.0, b),
             ["svt_sgm_float_strips"]),
            (lambda b: sgm_aggregate_hwd(q, 16, 128, num_paths, image, True, 32, b),
             ["svt_sgm_paths"]),
            (lambda b: sweep_pair(vol, p2_y, 4.0, diagonals, b), pair),
            (lambda b: sweep_pair(vt, pt, 4.0, diagonals, b), pair),
            (lambda b: sgm_extract_fused(vol, p2_y, p2_x, 4.0, num_paths, True, 0.95, 1.5, b),
             ["svt_sgm_float_strips", "svt_extract_maps"]),
            (lambda b: sgm_extract_fused(q, qy, qx, 16, num_paths, True, 0.95, 1.5, b),
             ["svt_sgm_paths", "svt_extract_maps"])):
        launched.clear()
        got = call("cuda")
        assert launched == entries
        _same(got, call("torch"))


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16"])
@pytest.mark.parametrize("h,w,D", [(12, 40, 16), (5, 7, 48), (3, 300, 3), (4, 130, 256),
                                   (540, 768, 64), (541, 766, 48)])
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
                                   (9, 768, 64), (3, 1100, 40), (2, 2500, 9), (540, 768, 64),
                                   (541, 766, 48)])
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


def test_k6_with_lr_is_one_launch(rng, launched):
    vol = _volume(rng, 12, 40, 16, "float32")
    got = extract_disparity_maps(vol, True, 0.95, 1.5, "cuda")
    assert launched == ["svt_extract_maps"]
    assert launched.args[0][7] == 1.5  # the LR check inside that launch
    _same(got, extract_disparity_maps(vol, True, 0.95, 1.5, "torch"))


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_integer_two_view_runs_no_standalone_lr_gather(rng, launched, dtype):
    img = np.floor(rng.uniform(0, 256, (24, 72))).astype(np.float32)
    left, right = _cuda(img[:, :64]), _cuda(img[:, 8:])
    cc = CostConfig(num_disparities=16, census_window=(5, 5), dtype=dtype)
    sc = SGMConfig(uniqueness=0.95, lr_max_diff=1.5)
    got = two_view_disparity(left, right, cc, sc)
    assert launched.count("svt_extract_maps") == 1 and "svt_lr_gather" not in launched
    assert launched.of("svt_extract_maps")[0][7] == 1.5  # the LR check inside that launch
    want = two_view_disparity(left, right, cc, sc, backend="torch")
    for field in ("disparity", "valid", "cost", "confidence"):
        _same(getattr(got, field), getattr(want, field))


def test_fused_lr_refuses_rows_past_the_cluster(rng):
    vol = torch.zeros((1, MAX_LR_WIDTH + 1, 3), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        extract_maps(vol, lr_max_diff=1.0, backend="cuda")
    extract_maps(vol[:, :MAX_LR_WIDTH].contiguous(), lr_max_diff=1.0, backend="cuda")


def _extraction_cases(vol, lr, rights=(False, True)):
    """K4 (with and without the right map) and K6 on `vol`, kernel against plain."""
    for subpixel, right in ((True, r) for r in rights):
        call = lambda b: extract_maps(vol, subpixel, 0.95, b, lr_max_diff=lr, right=right)  # noqa: E731
        _same(call("cuda"), call("torch"))
    call = lambda b: extract_disparity_maps(vol, True, 0.95 if lr else 0.0, lr, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


def test_tiled_extraction_at_d256_with_lr(rng):
    """The flat two-view cascade's extraction: the split form (its halo tile
    would take 198 KB), a 6-CTA cluster a row, 36 KB a CTA."""
    vol = _volume(rng, 540, 768, 256, "int16")
    plan = _tile_plan(768, 256, 2, True, True)
    assert plan.form == "split" and plan.per_row == 6 and plan.smem_bytes < 40_000
    _extraction_cases(vol, 1.5)


@pytest.mark.parametrize("lr", [0.0, 1.5])
@pytest.mark.parametrize("dtype,D", [("int16", 256), ("int16_wrapped", 256), ("int16", 255),
                                     ("int8", 384)])
@pytest.mark.parametrize("h,w", [
    (3, 100),  # W < D: a cluster of one CTA
    (4, 300),  # 3 CTAs of 100 columns (three tiles of 32 and one of 4), windows over 3 CTAs
    (3, 1000),  # 8 CTAs of 125 columns, windows over 4 CTAs
    (3, 1242),  # KITTI's width: 156 columns a CTA, four tiles of 32 and one of 28
])
def test_split_extraction_kernel(rng, h, w, dtype, D, lr):
    """The split form (staged once, right view from partial keys joined over
    the row's cluster) against the plain route, with and without the right
    map and the LR check: int16 at D = 256 (an 8-path total that wrapped
    too, and D = 255, staged an element a thread), int8 at D = 384."""
    if dtype == "int16_wrapped":
        vol = _cuda(rng.integers(-32768, 32768, (h, w, D)).astype(np.int16))
    else:
        vol = _volume(rng, h, w, D, dtype)
    plan = _tile_plan(w, D, vol.element_size(), True, lr > 0)
    assert plan.form == "split" and plan.per_row == min(8, -(-w // 128))
    _extraction_cases(vol, lr)


def test_split_extraction_of_an_offset_view(rng):
    """The split form on a view one element into its buffer: not 4-byte
    aligned, so it stages an element a thread."""
    h, w, D = 3, 700, 256
    vol = _volume(rng, h, w, D, "int16")
    buf = torch.empty(h * w * D + 1, dtype=vol.dtype, device=vol.device)
    view = buf[1:].view(h, w, D)
    view.copy_(vol)
    assert view.data_ptr() % 4 != 0 and _tile_plan(w, D, 2, True, True).form == "split"
    _extraction_cases(view, 1.5)
    _extraction_cases(view, 0.0)


@pytest.mark.parametrize("dtype", ["int8", "int16", "float32"])
def test_tiled_extraction_at_the_array_shape(rng, dtype):
    """The array paths' extraction (270x360x128, no LR check, no right view)."""
    vol = _volume(rng, 270, 360, 128, dtype)
    assert _tile_plan(360, 128, vol.element_size(), False, False).halo == 0
    _extraction_cases(vol, 0.0, rights=(False,))


@pytest.mark.parametrize("D,tile", [(256, 0), (200, 64), (220, 32)])
def test_float32_extraction_on_narrow_tiles_and_the_generic_form(rng, D, tile):
    """float32 with the right view: the plan narrows the tile as the halo
    grows, and at D = 256 no tile fits (the generic form)."""
    vol = _volume(rng, 6, 768, D, "float32")
    assert _tile_plan(768, D, 4, True, True).tile == tile
    _extraction_cases(vol, 1.5)


@pytest.mark.parametrize("dtype,D", [("int8", 64), ("int16", 64), ("float32", 32), ("int16", 97)])
def test_tiled_extraction_of_an_offset_view(rng, dtype, D):
    """A contiguous view that starts one element into its buffer: not 16-byte
    aligned, so the kernel stages an element a thread."""
    h, w = 7, 300
    vol = _volume(rng, h, w, D, dtype)
    buf = torch.empty(h * w * D + 1, dtype=vol.dtype, device=vol.device)
    view = buf[1:].view(h, w, D)
    view.copy_(vol)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _extraction_cases(view, 1.5)
    _extraction_cases(view, 0.0)


def test_tiled_extraction_d97_int16(rng):
    vol = _volume(rng, 9, 500, 97, "int16")
    _extraction_cases(vol, 1.5)
    _extraction_cases(vol, 0.0)


@pytest.mark.parametrize("D", [16, 64, 256])
def test_tiled_extraction_of_wrapped_int16_totals(rng, D):
    """An 8-path int16 total that wrapped: negative costs and costs above BIG."""
    vol = _cuda(rng.integers(-32768, 32768, (5, 768, D)).astype(np.int16))
    _extraction_cases(vol, 1.5)
    _extraction_cases(vol, 0.0)


@pytest.mark.parametrize("row", [r[0] for r in EXTRACT_ROWS])
def test_extraction_at_every_path_shape(rng, row):
    """K4 (with and without the right map) and K6 on the volume each path
    hands the extraction (the SGM totals of a seeded pair, raw int8 costs,
    the float SGM total): the tiled form at every path's row, the generic
    form at the last (float32, D = 256, LR)."""
    _, kernel, (h, w, D), vtype, lr = next(r for r in EXTRACT_ROWS if r[0] == row)
    vol = extraction_volume(torch, h, w, D, vtype)
    form = _tile_plan(w, D, vol.element_size(), lr, lr).form
    assert (form == "generic") == (row == "float32_d256_lr")
    for right in ((False, True) if kernel == "K4" else (False,)):
        call = extraction_call(extract_maps, extract_disparity_maps, kernel, vol, lr, right)
        _same(call("cuda"), call("torch"))


def test_extraction_entry_point_refuses_a_plan_it_does_not_take(rng):
    """svt_extract_maps checks the form, tile and stride it is handed."""
    h, w, D = 4, 300, 64
    vol = _volume(rng, h, w, D, "int16")
    out = [torch.empty((h, w), dtype=torch.float32, device="cuda") for _ in range(4)]
    valid = torch.empty((h, w), dtype=torch.bool, device="cuda")

    def launch(form, tile, stride_words, lr=1.5, right=True, total=vol, size=2):
        _native.launch("svt_extract_maps", vol.device, total.data_ptr(), size, h, w, D, 1, 0.95,
                       lr, FORMS.index(form) if isinstance(form, str) else form, tile,
                       stride_words, out[0].data_ptr(), out[1].data_ptr(), valid.data_ptr(),
                       out[2].data_ptr(), out[3].data_ptr() if right else None)

    plan = _tile_plan(w, D, 2, True, True)
    launch(plan.form, plan.tile, plan.stride_words)
    launch("generic", 0, plan.stride_words)
    launch("split", 32, 36)  # the split form takes any integer right view
    launch("split", 32, 36, lr=0.0)
    f32 = vol.to(torch.float32)
    for form, tile, stride_words, kw in (
            ("tiled", 96, 33, {}), ("tiled", 128, 31, {}), ("tiled", 128, 20000, {}),
            ("tiled", 256, 33, {}), ("split", 64, 36, {}), ("split", 32, 28, {}),
            ("split", 32, 33, {}),  # a staged column off 16 bytes
            ("split", 32, 36, dict(lr=0.0, right=False)),  # no right view to split
            ("split", 32, 68, dict(total=f32, size=4)),  # float32 volumes keep the tiled form
            (3, 64, 33, {}), (-1, 64, 33, {})):
        with pytest.raises(RuntimeError, match="svt_extract_maps"):
            launch(form, tile, stride_words, **kw)
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("margin", [3.0, 40.0])
@pytest.mark.parametrize("pad", [1, 9, 36, 49])
@pytest.mark.parametrize("shape", [(4, 45, 61), (4, 270, 360), (33, 17), (2, 7, 1),
                                   (1, 3, 13000)])
def test_hat_sample_2d_kernel(rng, shape, pad, margin):
    """The 2-D form against two K9 launches (along rows, then along columns)
    and against its plain twin, t up to `margin` past the taps; W = 13000
    opts into shared memory past 48 KB; (4, 270, 360) at pad 49 is the array
    cascade's pre-warp."""
    values = _cuda(rng.uniform(0, 255, shape).astype(np.float32))
    t_rows, t_cols = (_cuda(rng.uniform(-pad - margin, pad + margin, shape).astype(np.float32))
                      for _ in range(2))
    got = hat_sample_2d(values, t_rows, t_cols, -pad, pad, "cuda")
    two = hat_sample(hat_sample(values, t_rows, -pad, pad, axis=-2, backend="cuda"), t_cols,
                     -pad, pad, backend="cuda")
    _same(got, two)
    _same(got, hat_sample_2d(values, t_rows, t_cols, -pad, pad, "torch"))


def test_hat_sample_2d_counts_and_refuses_wide_rows(rng, launched):
    v = _cuda(rng.uniform(0, 255, (2, 5, 9)).astype(np.float32))
    hat_sample_2d(v, v, v, -2, 2, "cuda")
    assert launched == ["svt_hat_sample_2d"]
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


# ---- K2/K3 redesigned: family walks into int16 buffers, no atomics ----------------------------

@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("h,w,D", [*((7, 19, D) for D in (3, 31, 32, 33, 64, 129, 256)),
                                   (540, 768, 64)])
def test_sgm_paths_kernel_int16_totals_that_wrap(rng, h, w, D, num_paths):
    """int16 costs large enough that the 8-path int32 sum passes 32767: the
    int16 total is that sum wrapped, on the vector (D % 8 == 0) and scalar forms."""
    vol = _cuda(rng.integers(3000, 9000, (h, w, D)).astype(np.int16))
    image = _cuda(np.floor(rng.uniform(0, 256, (h, w))).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 384, torch.int16, vol.device, image, True, 96)
    call = lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, 32, num_paths, b)  # noqa: E731
    got = call("cuda")
    _same(got, call("torch"))
    assert got.dtype == torch.int16


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("h,w,D", [(1, 40, 64), (33, 1, 64), (1, 1, 8), (2, 300, 16),
                                   (300, 2, 24), (37, 29, 256), (540, 768, 256)])
def test_sgm_paths_kernel_thin_and_deep(rng, h, w, D, num_paths):
    """Lines of length 1 and 2, lines of 300 steps, one pixel, D=256."""
    vol = _cuda(rng.integers(0, 71, (h, w, D)).astype(np.int8))
    image = _cuda(np.floor(rng.uniform(0, 256, (h, w))).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 96, torch.int16, vol.device, image, True, 24)
    call = lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, 8, num_paths, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("dtype,offset", [("int8", 1), ("int8", 8), ("int8", 3), ("int16", 1),
                                          ("int16", 4)])
def test_sgm_paths_kernel_misaligned_views(rng, dtype, offset):
    """Cost volumes and P2 maps that are views `offset` elements into their
    storage: the vector form needs aligned buffers, the scalar form takes any."""
    h, w, D = 9, 23, 64
    n = h * w * D
    storage = _cuda(rng.integers(0, 71, n + offset).astype(dtype))
    vol = storage[offset:].view(h, w, D)
    image = _cuda(np.floor(rng.uniform(0, 256, (h, w))).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 96, torch.int16, vol.device, image, True, 24)
    p2s = _cuda(np.zeros(h * w + 1, np.int16))
    p2s[1:] = p2_y.reshape(-1)
    p2_odd = p2s[1:].view(h, w)  # 2 bytes past a 4-byte boundary
    for py, px in ((p2_y, p2_x), (p2_odd, p2_x), (p2_y, p2_odd)):
        call = lambda b: sgm_aggregate_paths(vol, py, px, 8, 8, b)  # noqa: E731
        _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("num_paths", [4, 8])
def test_k10_k12_integer_routes_on_the_new_scans(rng, num_paths):
    h, w, D = 23, 41, 64
    q = _cuda(rng.integers(2000, 6000, (h, w, D)).astype(np.int16))
    image = _cuda(rng.uniform(0, 256, (h, w)).astype(np.float32))
    _same(sgm_aggregate_hwd(q, 16, 128, num_paths, image, True, 32, "cuda"),
          sgm_aggregate_hwd(q, 16, 128, num_paths, image, True, 32, "torch"))
    qy, qx = p2_maps((h, w), 128, torch.int16, q.device, image, True, 32)
    q8 = _cuda(rng.integers(0, 71, (h, w, D)).astype(np.int8))
    for vol in (q, q8):
        _same(sgm_extract_fused(vol, qy, qx, 16, num_paths, True, 0.95, 1.5, "cuda"),
              sgm_extract_fused(vol, qy, qx, 16, num_paths, True, 0.95, 1.5, "torch"))


@pytest.mark.parametrize("h,w,D", [(20, 30, 64), (540, 768, 64)])
def test_integer_scans_launch_no_zero_fill_and_no_narrowing(rng, h, w, D):
    """The wrapper's own work around the kernel: two allocations (the int16
    total and the partials) and one entry point; no zero-fill, no copy."""
    vol = _cuda(rng.integers(0, 71, (h, w, D)).astype(np.int8))
    p2 = _cuda(np.full((h, w), 96, np.int16))
    sgm_aggregate_paths(vol, p2, p2, 8, 8)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        total = sgm_aggregate_paths(vol, p2, p2, 8, 8)
    ops = {e.name for e in prof.events()}
    assert total.dtype == torch.int16
    assert not ops & {"aten::zeros", "aten::zero_", "aten::fill_", "aten::to", "aten::_to_copy",
                      "aten::copy_"}, ops


# ---- K7 redesigned: the strip route (the down and up groups in row strips kept in L2) ----

def _strip_inputs(rng, h, w, D):
    vol = _float_volume(rng, h, w, D)
    image = _cuda(rng.uniform(0, 256, (h, w)).astype(np.float32))
    return (vol, *p2_maps((h, w), 96.0, torch.float32, vol.device, image, True, 24.0))


@pytest.mark.parametrize("h,w,D,orders", [
    (540, 768, 64, ORDERS), (541, 766, 48, ORDERS), (270, 360, 128, ("wdh",)),
    (75, 20, 64, ORDERS),  # W = 20 < S = 32
])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_float_sgm_strip_route(rng, launched, h, w, D, orders, num_paths):
    """The strip route at the float paths' shapes and the parity shapes,
    bit-exact to the plain twin in every order given."""
    vol, p2_y, p2_x = _strip_inputs(rng, h, w, D)
    assert _strip_plan(h, w, D, num_paths, ALL_SWEEPS, True) is not None
    for order in orders:
        launched.clear()
        got = sgm_aggregate_float(vol, p2_y, p2_x, 8.0, num_paths, order=order, backend="cuda")
        assert launched == ["svt_sgm_float_strips"]
        _same(got, sgm_aggregate_float(vol, p2_y, p2_x, 8.0, num_paths, order=order,
                                       backend="torch"))


def test_float_sgm_generic_form_where_the_plan_refuses(rng, launched):
    """D % 8 != 0 and a costs view 4 bytes off alignment take the generic form."""
    vol, p2_y, p2_x = _strip_inputs(rng, 30, 41, 60)
    storage = _float_volume(rng, 1, 1, 30 * 41 * 64 + 1).reshape(-1)
    for v in (vol, storage[1:].view(30, 41, 64)):
        py, px = (p2_y, p2_x)
        launched.clear()
        got = sgm_aggregate_float(v, py, px, 8.0, 8, backend="cuda")
        assert launched == ["svt_sgm_paths_f32", "svt_sgm_combine_f32"]
        _same(got, sgm_aggregate_float(v, py, px, 8.0, 8, backend="torch"))


def test_strip_entry_point_refuses_what_the_plan_would_not_give(rng):
    """svt_sgm_float_strips refuses, before any launch, a strip height the
    plan would not give, D % 8 != 0, unaligned buffers, bad paths or order;
    the output keeps what it held."""
    h, w, D = 20, 40, 64
    vol, p2_y, p2_x = _strip_inputs(rng, h, w, D)
    S = _strip_plan(h, w, D, 8, ALL_SWEEPS, True)
    out = torch.full((h, w, D), -7.0, device="cuda")
    scratch = torch.empty((3, h, w, D), device="cuda")
    ring = torch.empty((2, 3, S, w, D), device="cuda")

    def launch(vol_ptr=vol.data_ptr(), d=D, num_paths=8, order=0, strip_rows=S,
               ring_ptr=ring.data_ptr()):
        _native.launch("svt_sgm_float_strips", vol.device, vol_ptr, p2_y.data_ptr(),
                       p2_x.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
                       scratch[1].data_ptr(), scratch[2].data_ptr(), ring_ptr, h, w, d, 8.0,
                       num_paths, order, strip_rows)

    for bad in (dict(strip_rows=S // 2), dict(strip_rows=S + 1), dict(d=60), dict(d=264),
                dict(vol_ptr=vol.data_ptr() + 4), dict(ring_ptr=ring.data_ptr() + 8),
                dict(num_paths=6), dict(order=4)):
        with pytest.raises(RuntimeError, match="svt_sgm_float_strips"):
            launch(**bad)
    torch.cuda.synchronize()
    assert bool((out == -7.0).all())  # nothing ran
    launch()
    _same(out, sgm_aggregate_float(vol, p2_y, p2_x, 8.0, 8, backend="torch"))


def test_float_sgm_strip_route_does_not_wait(rng):
    """The strip route's three launches (two of them cooperative) return
    while a spin runs on the card."""
    vol, p2_y, p2_x = _strip_inputs(rng, 270, 360, 128)
    waited_not, got = _queued_behind_a_spin(
        lambda: sgm_aggregate_float(vol, p2_y, p2_x, 8.0, 8, order="wdh"))
    assert waited_not
    _same(got, sgm_aggregate_float(vol, p2_y, p2_x, 8.0, 8, order="wdh", backend="torch"))


# ---- K8 redesigned: the specialised kernel (patch 3, 5, 7; top-k <= 8) and the generic one ----

def _sweep_inputs(rng, S, h, w, D, spread=12.0):
    ref = _cuda(rng.uniform(0, 255, (h, w)).astype(np.float32))
    src = _cuda(rng.uniform(0, 255, (S, h, w)).astype(np.float32))
    sh = rng.uniform(-spread, spread, (D, S, 2)).astype(np.float32)
    sh[1::4] = np.round(sh[1::4])
    return ref, src, _cuda(sh)


@pytest.mark.parametrize("valid_mean,topk", [(False, None), (True, None), (False, 2)])
@pytest.mark.parametrize("patch", [3, 5, 7, 9, 17])
def test_plane_sweep_kernel_every_patch_route(rng, patch, valid_mean, topk):
    """Patch 3, 5 and 7 run the specialised kernel, 9 and 17 the generic one."""
    ref, src, shifts = _sweep_inputs(rng, 4, 29, 47, 16)
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, valid_mean, topk, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("topk,patch", [
    *(pytest.param(k, 5, id=str(k)) for k in (1, 6, 8, 9, 23)),
    # every slot count of the specialised kernel (k rounded up to even) at each patch
    *((k, p) for p in (3, 5, 7) for k in range(1, 9)),
])
def test_plane_sweep_kernel_topk_in_registers_and_in_shared_memory(rng, topk, patch):
    """k <= 8 keeps its slots in registers, 9 <= k in shared memory."""
    ref, src, shifts = _sweep_inputs(rng, 24, 21, 37, 12, spread=20.0)
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, False, topk, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("S,topk,h,w,D", [
    *((4, None, h, w, D) for h, w, D in (
        (17, 29, 8), (45, 61, 13), (16, 28, 9), (33, 100, 17), (1, 5, 3), (90, 3, 8),
        # one either side of the strip (58, 60, 62 columns at patch 7, 5, 3, and
        # twice that) and of the block's 16 and 24 rows
        (15, 57, 8), (17, 59, 9), (23, 61, 8), (25, 63, 16), (15, 115, 8), (17, 117, 5),
        (31, 119, 8), (33, 121, 8), (47, 123, 8), (49, 125, 12))),
    (24, 6, 270, 360, 128),  # the to_center array shape
])
def test_plane_sweep_kernel_ragged_tiles_and_wide_shifts(rng, S, topk, h, w, D):
    """Shapes that are not multiples of the tile (a strip of 64 - 2M columns
    by 24 rows, 16 at patch 7, in the specialised kernel), planes that are
    not multiples of the chunk of 8, and shifts that move by more than a tile
    from plane to plane within one chunk."""
    ref, src, shifts = _sweep_inputs(rng, S, h, w, D, spread=70.0)
    for patch in (3, 5, 7):
        call = lambda b: plane_sweep_census(ref, src, shifts, patch, False, topk, b)  # noqa: E731
        _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("values", ["signed_zeros_and_ties", "negative", "infinities_and_nan"])
@pytest.mark.parametrize("patch,valid_mean,topk", [(3, False, None), (5, False, 6), (5, True, None),
                                                   (7, False, 3)])
def test_plane_sweep_kernel_sign_of_difference(rng, values, patch, valid_mean, topk):
    """The specialised kernel takes each census bit as the sign of nb - centre
    over values normalised by adding +0: images of -0.0 and +0.0 among exact
    ties (integer shifts keep them ties after the warp), of negative values,
    and of infinities and NaN (the warp's products turn them into NaN, a
    difference with a NaN is the positive canonical NaN)."""
    S, h, w, D = 8, 23, 70, 12
    if values == "signed_zeros_and_ties":
        pool = np.array([-0.0, 0.0, 1.0, -1.0, 2.0], np.float32)
    elif values == "negative":
        pool = -np.round(rng.uniform(0, 4, 16)).astype(np.float32) - 0.5 * (rng.uniform(size=16) < 0.3)
    else:
        pool = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.0, -3.0, 1e38, -1e38], np.float32)
    ref = _cuda(rng.choice(pool, (h, w)).astype(np.float32))
    src = _cuda(rng.choice(pool, (S, h, w)).astype(np.float32))
    sh = rng.uniform(-9, 9, (D, S, 2)).astype(np.float32)
    sh[::2] = np.round(sh[::2])  # integer shifts: the warp copies the values, ties stay ties
    shifts = _cuda(sh)
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, valid_mean, topk, b)  # noqa: E731
    got, want = call("cuda"), call("torch")
    _same(got, want)


@pytest.mark.parametrize("frames", ["8bit", "rendered"])
@pytest.mark.parametrize("topology,fusion,patch,h,w,D", [
    *((t, f, 5, 270, 360, 128) for t in ("CROSS", "to_center") for f in ("rig", "mean")),
    ("CROSS", "rig", 3, 270, 360, 128), ("CROSS", "rig", 7, 270, 360, 128),
    ("to_center", "rig", 5, 271, 361, 97),  # an odd shape, planes not a multiple of 8
])
def test_plane_sweep_kernel_rig_shift_tables(rng, topology, fusion, patch, h, w, D, frames):
    """The 5x5 rig's own translation shift tables at the array cells' size,
    270x360x128 (CROSS: 4 sources, to_center: 24), each in the rig's fusion
    (the ceiling-padded mean at CROSS, the mean of the 6 best at to_center)
    and in the valid mean, at patch 3, 5 and 7 and at 271x361x97; on random
    8-bit frames and on the rig's rendered (non-integer) views."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
    from stereovisionarray_tpu_torch.models.array_pipeline import reference_and_sources
    from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts

    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(h, w))
    cfg = config.EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                            "plane_sweep.num_planes": D,
                                            "plane_sweep.topology": topology})
    ps = cfg.plane_sweep
    ref_index, src_index = reference_and_sources(cfg, 25)
    depths = inverse_depth_samples(ps.z_near, ps.z_far, D)
    shifts = _cuda(translation_shifts(cams, ref_index, src_index, depths).swapaxes(0, 1))
    images = (np.round(rng.uniform(0, 255, (25, h, w))).astype(np.float32) if frames == "8bit"
              else render_camera_array(cams, (h, w))[0])
    ref, src = _cuda(images[ref_index]), _cuda(images[list(src_index)])
    S = len(src_index)
    topk = ps.topk if fusion == "rig" and ps.topk < S else None
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, fusion == "mean",  # noqa: E731
                                        topk, b)
    _same(call("cuda"), call("torch"))


# ---- host-device waits: each timed path enqueues without waiting for the card ----------------

def _queued_behind_a_spin(fn):
    """fn() twice to warm up (kernels, pinned staging buffers), then again
    while a ~0.5 s spin runs on the card: True if it returned before the
    spin ended (it never waited)."""
    fn()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)
    spinning = torch.cuda.Event()
    spinning.record()
    out = fn()
    returned_first = not spinning.query()
    torch.cuda.synchronize()
    return returned_first, out


def _array_scene(h=45, w=60, planes=32):
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array

    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(h, w))
    images, _ = render_camera_array(cams, (h, w))
    cfg = EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                     "plane_sweep.num_planes": planes,
                                     "plane_sweep.topology": "CROSS"})
    return cams, _cuda(images), cfg


def test_resize_linear_does_not_wait(rng):
    from stereovisionarray_tpu_torch.models.cascade import _linear_resize_weights, resize_linear

    x = _cuda(rng.uniform(0, 60, (34, 48)).astype(np.float32))
    waited_not, got = _queued_behind_a_spin(lambda: resize_linear(x, (136, 192)))
    assert waited_not
    # the same products with the weights copied the blocking way
    wh, ww = (torch.from_numpy(_linear_resize_weights(m, n)).cuda()
              for m, n in ((34, 136), (48, 192)))
    _same(got, (wh.T @ x) @ ww)


@pytest.mark.parametrize("fn", ["disparity_to_depth", "depth_to_disparity"])
def test_guarded_inverse_does_not_wait(rng, fn):
    from stereovisionarray_tpu_torch.models import two_view

    x = _cuda(rng.uniform(-1, 64, (40, 50)).astype(np.float32))
    conv = getattr(two_view, fn)
    waited_not, got = _queued_behind_a_spin(lambda: conv(x, 0.12, 700.0))
    assert waited_not
    _same(got, conv(x.cpu(), 0.12, 700.0).cuda())


def test_plane_sweep_volume_does_not_wait(rng):
    """The plane depths and the shift table reach the card without a wait."""
    from stereovisionarray_tpu_torch.models.array_pipeline import _shift_warp_pad
    from stereovisionarray_tpu_torch.models.plane_sweep import plane_sweep_volume

    cams, images, cfg = _array_scene()
    src = (7, 11, 13, 17)
    pad = _shift_warp_pad(cams, 12, src, cfg)
    run = lambda: plane_sweep_volume(images, cams, 12, src, cfg.plane_sweep, shift_pad=pad)  # noqa: E731
    waited_not, got = _queued_behind_a_spin(run)
    assert waited_not
    _same(got, plane_sweep_volume(images, cams, 12, src, cfg.plane_sweep, shift_pad=pad,
                                  backend="torch"))


def _sites_do_not_wait(monkeypatch, module):
    """Wrap `module`'s host_to_device: each call starts a fresh spin on the
    card and must return before it ends (the copy is enqueued, not waited
    for). Returns the list of per-call results."""
    real, results = module.host_to_device, []

    def spy(a, device):
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 28)
        spinning = torch.cuda.Event()
        spinning.record()
        out = real(a, device)
        results.append(not spinning.query())
        return out

    monkeypatch.setattr(module, "host_to_device", spy)
    return results


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_two_view_cascade_tables_do_not_wait(rng, monkeypatch, mode):
    """The resize weight matrices of the two-view cascade reach the card
    without waiting for it, and the cascade equals its plain route."""
    from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
    from stereovisionarray_tpu_torch.models import cascade, cascade_two_view_disparity

    img = np.floor(rng.uniform(0, 256, (48, 168))).astype(np.float32)
    left, right = _cuda(img[:, :128]), _cuda(img[:, 40:])
    cc, sc = CostConfig(num_disparities=64, dtype="int8"), SGMConfig(num_paths=8)
    run = lambda b="auto": cascade_two_view_disparity(left, right, cc, sc, 4, 16, 8, backend=b,  # noqa: E731
                                                      mode=mode)
    run()  # warm: pinned staging buffers, kernels
    results = _sites_do_not_wait(monkeypatch, cascade)
    cascade._resize_weights_on.cache_clear()  # the weights reach the card again, under the spy
    got = run()
    assert results and all(results), results
    want = run("torch")
    for field in ("disparity", "valid", "cost", "confidence"):
        _same(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_array_cascade_tables_do_not_wait(rng, monkeypatch, mode):
    """The plane depths, shift tables, a / c and band tables of the array
    cascade (coarse and fine sweeps, pre-warp, decode) reach the card without
    waiting for it, and the cascade equals its plain route."""
    from stereovisionarray_tpu_torch.models import cascade_sweep, plane_sweep
    from stereovisionarray_tpu_torch.models.array_pipeline import (
        _shift_warp_pad,
        reference_and_sources,
    )

    cams, images, cfg = _array_scene(planes=64)
    ps = cfg.plane_sweep
    ref, src = reference_and_sources(cfg, images.shape[0])
    pad = _shift_warp_pad(cams, ref, src, cfg)
    offsets, _ = cascade_sweep.cascade_static_params(cams, ref, src, ps, 24)
    run = lambda b="auto": cascade_sweep.cascade_plane_sweep_depth(  # noqa: E731
        images, cams, ref, src, ps, cfg.sgm, backend=b, shift_pad=pad, fine_planes=24,
        band_offsets=offsets, mode=mode)
    run()
    results = _sites_do_not_wait(monkeypatch, cascade_sweep)
    results_sweep = _sites_do_not_wait(monkeypatch, plane_sweep)
    got = run()
    assert results and all(results), results
    assert results_sweep and all(results_sweep), results_sweep
    want = run("torch")
    for field in ("depth", "plane", "cost", "valid", "num_views", "confidence"):
        _same(getattr(got, field), getattr(want, field))


def test_host_tables_are_copied_once(rng):
    """A table the timed paths hand over again (same contents) is the copy
    already on the card; new contents are copied, values unchanged."""
    from stereovisionarray_tpu_torch.backend import host_to_device

    a = rng.uniform(-50, 50, (128, 4, 2)).astype(np.float32)
    first = host_to_device(a, "cuda:0")
    assert host_to_device(a.copy(), torch.device("cuda", 0)) is first
    assert host_to_device(torch.from_numpy(a), first.device) is first
    b = a + 1.0
    other = host_to_device(b, first.device)
    assert other is not first
    _same(other, torch.from_numpy(b).cuda())
    _same(first, torch.from_numpy(a).cuda())


@pytest.mark.parametrize("patch", [5, 17])
def test_plane_sweep_kernel_topk_near_its_cap(rng, patch):
    """Top-200 of 201 sources on the generic kernel: with patch 5 the chunk's
    results fit beside the 200 slots in shared memory, with patch 17 they do
    not and each plane's result goes straight out."""
    ref, src, shifts = _sweep_inputs(rng, 201, 9, 12, 10, spread=6.0)
    call = lambda b: plane_sweep_census(ref, src, shifts, patch, False, 200, b)  # noqa: E731
    _same(call("cuda"), call("torch"))


@pytest.mark.parametrize("cascade", [False, True])
def test_array_pipeline_with_cameras_on_the_card_does_not_wait(rng, cascade):
    """A rig whose tensors live on the card answers the host's questions
    (shift bound, shift tables, baselines, focal length) from its numpy copy,
    so array_depth_pipeline returns while a spin runs on the card, with the
    outputs of the same rig on the host. The refinement pass runs too
    (refine.iterations 1): its fused kernels are three launches, which the
    device's launch queue holds."""
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    cams, images, cfg = _array_scene(h=48, w=64, planes=64)
    cfg = cfg.override(**{"refine.iterations": 1, "plane_sweep.cascade": cascade,
                          "plane_sweep.cascade_fine_planes": 24})
    cams_cuda = cams.to("cuda")
    assert cams_cuda.fx.is_cuda and cams_cuda.host() is cams.host()
    waited_not, got = _queued_behind_a_spin(lambda: array_depth_pipeline(images, cams_cuda, cfg))
    assert waited_not
    want = array_depth_pipeline(images, cams, cfg)
    for field in ("depth", "refined_depth", "disparity", "valid"):
        _same(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("stage", ["temporal_update", "detect_face_ellipse", "detect_face",
                                   "fit_landmarks", "face_mask"])
def test_served_stages_do_not_wait(rng, stage):
    """The temporal filter and the face ROI select on the device (no host
    read of a peak index or a found flag): each returns while a spin runs on
    the card, with the values of the same call on the host. face_mask, whose
    ~1,400 launches a call are more than the device's launch queue holds
    (which blocks the host by itself, as the refinement's do: ROADMAP.md
    queue 3), is held to no synchronizing call instead; detect_face and
    fit_landmarks, its two halves, take the spin."""
    from stereovisionarray_tpu_torch.models import temporal_init, temporal_update
    from stereovisionarray_tpu_torch.roi import (
        detect_face,
        detect_face_ellipse,
        face_mask,
        fit_landmarks,
    )

    img = render_head(h=180, w=240, rng=rng)[0]
    d = rng.uniform(1, 60, img.shape).astype(np.float32)
    v, c = rng.uniform(size=img.shape) > 0.2, rng.uniform(0, 1, img.shape).astype(np.float32)
    run = {
        "temporal_update": lambda t: temporal_update(temporal_init(img.shape, t[0].device),
                                                     *t[1:])[1],
        "detect_face_ellipse": lambda t: detect_face_ellipse(t[0]),
        "detect_face": lambda t: detect_face(t[0]),
        "fit_landmarks": lambda t: (fit_landmarks(t[0], detect_face(t[0], verify_parts=False)),),
        "face_mask": lambda t: face_mask(t[0]),
    }[stage]
    host = [torch.from_numpy(a) for a in (img, d, v, c)]
    card = [a.cuda() for a in host]
    want = run(host)
    if stage == "face_mask":
        run(card)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (got.cpu() == want).float().mean() > 0.999
        return
    if stage == "fit_landmarks":
        det = detect_face(card[0], verify_parts=False)
        waited_not, got = _queued_behind_a_spin(lambda: (fit_landmarks(card[0], det),))
    else:
        waited_not, got = _queued_behind_a_spin(lambda: run(card))
    assert waited_not
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-3)


def test_throughput_stream_on_the_card(rng):
    """Frames copied to the card (pinned, non_blocking) and stepped there
    come back in order with their values; each output is complete when the
    stream hands it over."""
    from stereovisionarray_tpu_torch.parallel import throughput_stream

    frames = [rng.uniform(0, 255, (64, 96)).astype(np.float32) for _ in range(6)]
    outs, fps = throughput_stream(lambda x: x * 2.0 + 1.0, frames, depth=3)
    assert fps > 0 and len(outs) == len(frames)
    for out, frame in zip(outs, frames):
        assert out.is_cuda
        _same(out, _cuda(frame) * 2.0 + 1.0)


# ---- SfM and calibration: paths (a), (b) and (c) on the card ---------------------------------

@pytest.fixture(scope="module")
def calibrated():
    """tests/test_torch_calibration.py's lensed 3x3 rig at 180x240 (k1 = -0.4,
    a 5 mm guess) on the card: (lensed views, guess, config, calibrate())."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.geometry import Distortion, camera_array_from_numpy, distort_image
    from stereovisionarray_tpu_torch.models import calibrate_array

    rig = reference_rig(rows=3, cols=3, spacing=0.05, origin=(-0.05, -0.05), resolution=(180, 240))
    lensed = distort_image(_cuda(render_camera_array(rig, (180, 240))[0]), rig.to("cuda"),
                           Distortion(k1=-0.4, k2=0.03))[0]
    host = rig.host()
    t_bad = host.t.copy()
    t_bad[1:] += np.random.default_rng(11).normal(0, 0.005, t_bad[1:].shape).astype(np.float32)
    init = camera_array_from_numpy(host.fx, host.fy, host.cx, host.cy, host.R, t_bad, device="cuda")
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3, "sfm.ba_iterations": 30,
                                     "plane_sweep.num_planes": 32, "plane_sweep.topology": "CROSS"})

    def calibrate():
        return calibrate_array(lensed, init, 4, cfg.sfm, rounds=2, estimate_distortion=True)

    calibrate()  # warm: the index tables reach the card once
    torch.cuda.synchronize()
    return lensed, init, cfg, calibrate


def _calibration_fields(out):
    return (out.cameras.R, out.cameras.t, out.points, out.cost, out.num_obs, out.inlier_reproj,
            *out.distortion)


def test_calibrate_array_makes_no_synchronizing_call(calibrated):
    """The whole calibration is enqueued without a host read; the one
    synchronizing call is the final copy of the cameras to their host copy."""
    import warnings

    calibrate = calibrated[3]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = calibrate()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, syncs
    assert out.cameras.fx.is_cuda and out.cameras.host_fields is not None
    np.testing.assert_array_equal(out.cameras.host_fields.R, out.cameras.R.cpu().numpy())


def test_calibrate_array_runs_are_bit_identical(calibrated):
    """Segment sums in a fixed order (no atomics): two runs agree bit for bit,
    cameras, points and the cost trajectory."""
    calibrate = calibrated[3]
    for a, b in zip(_calibration_fields(calibrate()), _calibration_fields(calibrate())):
        _same(a, b)


def test_calibrate_array_ignores_tf32(calibrated):
    """A caller's TF32 settings do not reach the calibration's products."""
    calibrate = calibrated[3]
    want = calibrate()
    prev_prec, prev_tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = calibrate()
        assert torch.get_float32_matmul_precision() == "high"  # the caller's setting restored
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    for a, b in zip(_calibration_fields(got), _calibration_fields(want)):
        _same(a, b)


def _undistorted(calibrated, out):
    from stereovisionarray_tpu_torch.geometry import Distortion, undistort_image

    return undistort_image(calibrated[0], out.cameras, Distortion(*out.distortion))[0]


def test_calibrated_depth_makes_no_synchronizing_call_and_matches_plain(calibrated, launched):
    """Path (b) on the calibrated rig (a general rig: the homography chain,
    then K2/K3 and K4): no synchronizing call (its chain of per-plane warps
    enqueues more launches than the device's launch queue holds, so a spin
    cannot tell), every output equal to backend="torch"."""
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    lensed, _, cfg, calibrate = calibrated
    out = calibrate()
    views = _undistorted(calibrated, out)
    array_depth_pipeline(views, out.cameras, cfg)
    torch.cuda.synchronize()
    launched.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = array_depth_pipeline(views, out.cameras, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {"svt_sgm_paths", "svt_extract_maps"} <= set(launched)
    assert "svt_plane_sweep" not in launched
    want = array_depth_pipeline(views, out.cameras, cfg, backend="torch")
    for field in ("depth", "refined_depth", "disparity", "refined_disparity", "valid"):
        _same(getattr(got, field), getattr(want, field))


def test_calibrated_depth_does_not_wait(calibrated):
    """Path (b) on two views of the calibrated rig (one source, 4 planes, one
    refinement pass: launches the device's queue holds) returns while a spin
    runs on the card: the rig answers the host from its numpy copy."""
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    out = calibrated[3]()
    views = _undistorted(calibrated, out)[[3, 4]].contiguous()
    cams = out.cameras[[3, 4]]
    assert cams.host_fields is not None and cams.fx.is_cuda
    cfg = calibrated[2].override(**{"camera.rows": 1, "camera.cols": 2,
                                    "plane_sweep.num_planes": 4, "refine.iterations": 1})
    waited_not, got = _queued_behind_a_spin(lambda: array_depth_pipeline(views, cams, cfg))
    assert waited_not
    want = array_depth_pipeline(views, cams, cfg, backend="torch")
    for field in ("depth", "refined_depth", "disparity", "refined_disparity", "valid"):
        _same(getattr(got, field), getattr(want, field))


def test_rectified_two_view_matches_plain(rng, launched):
    """Path (c) at 135x192, D = 32: a verged pair rectified, two-view SGM
    (K1, K2/K3, K4 with the fused LR check) and depth, equal to
    backend="torch"."""
    from stereovisionarray_tpu_torch.datasets.synthetic import SceneSpec, render_view
    from stereovisionarray_tpu_torch.geometry import (
        camera_array_from_numpy,
        look_at_rotation,
        rectified_disparity_to_depth,
        rectify_images,
        rectify_pair,
    )

    h, w = 135, 192
    f = 0.05 / (0.036 / w)
    eyes = np.array([[-0.0225, 0.0, -0.75], [0.0225, 0.0, -0.75]])
    R = np.stack([look_at_rotation(e, (0.0, 0.0, 0.25)).numpy() for e in eyes])
    t = np.einsum("nij,nj->ni", R, -eyes).astype(np.float32)
    cams = camera_array_from_numpy(np.full(2, f), np.full(2, f), np.full(2, w / 2.0),
                                   np.full(2, h / 2.0), R, t, device="cuda")
    left, right = (_cuda(render_view(cams, i, (h, w), SceneSpec())[0]) for i in (0, 1))
    cfg = (CostConfig(num_disparities=32, census_window=(7, 9), dtype="int8"),
           SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True))

    def run(backend):
        rect = rectify_pair(cams, 0, 1)
        lw, lv, rw, _ = rectify_images(left, right, rect)
        out = two_view_disparity(lw, rw, *cfg, backend=backend)
        return out, rectified_disparity_to_depth(out.disparity, rect), lv

    launched.clear()
    got = run("auto")
    assert {"svt_cost_volume", "svt_sgm_paths", "svt_extract_maps"} <= set(launched)
    want = run("torch")
    for field in ("disparity", "valid", "cost", "confidence"):
        _same(getattr(got[0], field), getattr(want[0], field))
    _same(got[1], want[1])
    _same(got[2], want[2])
    assert got[0].valid.float().mean() > 0.5


CLI_SMALL = ["--set", "camera.rows=3", "--set", "camera.cols=3",
             "--set", "plane_sweep.num_planes=32", "--set", "sgm.num_paths=4"]


@pytest.mark.parametrize("command", ["two-view", "depth"])
def test_cli_on_the_card_writes_the_cpu_artifacts(rng, tmp_path, launched, command):
    """`two-view` (int16 costs: K1, K2/K3, K4 with the LR check fused) and
    `depth` (K8, K2/K3, K4) with --device cuda write the .npz arrays, PNG
    pixels and PLY bytes that --device cpu writes. `depth` runs without the
    refinement: its float box sums are cumulative sums, in PyTorch's parallel
    scan order on the card (which the fused refinement kernels keep) and a
    sequential one on the CPU, so only the integer route is bit-identical
    across the two devices."""
    from pathlib import Path

    from stereovisionarray_tpu_torch.cli import main
    from stereovisionarray_tpu_torch.datasets import load_array, read_png

    data = str(tmp_path / "data")
    assert main(["render", "--output", data, "--resolution", "40", "56", *CLI_SMALL]) == 0
    if command == "depth":
        argv = ["depth", "--input", data, *CLI_SMALL, "--set", "refine.iterations=0"]
        files = ("depth.npz", "depth.png", "disparity.png", "error.png", "cloud.ply")
        kernels = {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps"}
    else:
        argv = ["two-view", "--left", f"{data}/view_004.png", "--right", f"{data}/view_003.png",
                "--set", "cost.num_disparities=32", "--baseline", "0.05", "--focal-px", "416.0"]
        files = ("two_view.npz", "disparity.png", "depth.png", "confidence.png")
        kernels = {"svt_cost_volume", "svt_sgm_paths", "svt_extract_maps"}
    out = {}
    for device in ("cpu", "cuda"):
        launched.clear()
        out[device] = tmp_path / device
        assert main([*argv, "--output", str(out[device]), "--device", device]) == 0
    assert kernels <= set(launched)
    for name in files:
        a, b = out["cpu"] / name, out["cuda"] / name
        if name.endswith(".npz"):
            got, want = load_array(str(b))[0], load_array(str(a))[0]
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        elif name.endswith(".png"):
            assert np.array_equal(read_png(str(b)), read_png(str(a))), name
        else:
            assert Path(b).read_bytes() == Path(a).read_bytes(), name
