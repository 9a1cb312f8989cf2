"""Each CUDA kernel of the port against its plain PyTorch twin on the same
CUDA tensors, bit-exact, across the configurations the kernels branch on:
every lanes-per-warp width of the SGM scans (D up to 32, 64, 128, 256),
census codes of one to four 64-bit words, int8 and int16 costs, 4 and 8 paths,
and images narrower than a tile or than the disparity range.

Needs a CUDA device and nvcc; without one every test skips. The GPU machine
has no JAX, so run these without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import extract_maps, lr_gather
from stereovisionarray_tpu_torch.ops.sgm import p2_maps
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_paths

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
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("h,w,D,window,bt_weight,dtype", [
    (17, 50, 3, (3, 3), 0.25, "int16"),  # W < one tile
    (33, 64, 12, (5, 5), 0.0, "int8"),
    (20, 129, 64, (7, 9), 0.25, "int8"),  # 62 bits: one word; ragged last tile
    (9, 70, 100, (11, 13), 0.25, "int16"),  # 142 bits: three words; D > W
    (6, 300, 256, (15, 17), 0.5, "int16"),  # 254 bits: four words
    (1, 1, 8, (7, 9), 0.25, "int16"),  # one pixel
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
