"""Port's SGM aggregation vs the JAX reference: the integer path bit-exact to
the Pallas sweeps (interpret mode), the float path to the XLA scans."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops.sgm import _edge_p2 as ref_edge_p2
from stereovisionarray_tpu.ops.sgm import sgm_aggregate as ref_sgm_aggregate
from stereovisionarray_tpu.ops.sgm import sgm_aggregate_reference
from stereovisionarray_tpu.ops.sgm_pallas import sgm_aggregate_pallas_hdw
from stereovisionarray_tpu_torch.ops import sgm as port
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_paths
from torch_launches import launched  # noqa: F401

H, W, D = 20, 28, 12


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).uniform(0, 255, (H, W)).astype(np.float32)


@pytest.mark.parametrize("dtype,hi", [("int16", 300), ("int8", 71)])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_integer_aggregation_bit_exact_to_pallas(image, num_paths, adaptive, dtype, hi):
    vol = np.random.default_rng(num_paths + hi).integers(0, hi, (H, W, D)).astype(dtype)
    want = sgm_aggregate_pallas_hdw(jnp.moveaxis(jnp.asarray(vol), -1, 1), 32, 384, num_paths,
                                    jnp.asarray(image), adaptive, 96, interpret=True)
    want = np.moveaxis(np.asarray(want), 1, -1)
    got = port.sgm_aggregate(torch.from_numpy(vol), 32, 384, num_paths,
                             torch.from_numpy(image), adaptive, 96)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_path_wrapper_runs_the_plain_scans_on_cpu(image, launched):
    vol = torch.from_numpy(np.random.default_rng(0).integers(0, 71, (H, W, D)).astype(np.int8))
    p2_y, p2_x = port.p2_maps((H, W), 96, torch.int16, vol.device, torch.from_numpy(image),
                              True, 24)
    want = port.aggregate_paths(vol, p2_y, p2_x, 8, 8)
    got = sgm_aggregate_paths(vol, p2_y, p2_x, 8, 8)
    assert torch.equal(got, want)
    assert launched == []  # CPU tensors never launch the kernel


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_float_aggregation_matches_xla(image, num_paths, adaptive):
    vol = np.random.default_rng(7).uniform(0, 60, (H, W, D)).astype(np.float32)
    want = np.asarray(ref_sgm_aggregate(jnp.asarray(vol), 4.0, 32.0, num_paths,
                                        jnp.asarray(image), adaptive, 8.0))
    got = port.sgm_aggregate(torch.from_numpy(vol), 4.0, 32.0, num_paths,
                             torch.from_numpy(image), adaptive, 8.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


def test_float_aggregation_matches_numpy_oracle():
    vol = np.random.default_rng(5).uniform(0, 30, (9, 11, 8)).astype(np.float32)
    want = sgm_aggregate_reference(vol, 4.0, 32.0, num_paths=8)
    got = port.sgm_aggregate(torch.from_numpy(vol), 4.0, 32.0, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("axis", [0, 1])
def test_edge_p2_bit_exact(image, axis, dtype):
    img = np.floor(image)  # integer intensities: ties in the rounding of P2 / (1 + g/2)
    want = np.asarray(ref_edge_p2(jnp.asarray(img), axis, 384, 96, jnp.dtype(dtype)))
    got = port._edge_p2(torch.from_numpy(img), axis, 384, 96, getattr(torch, dtype))
    np.testing.assert_array_equal(got.numpy(), want)
