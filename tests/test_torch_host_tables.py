"""The host tables and scalars of the timed paths, now handed to the card
without waiting for its stream (``backend.host_to_device``, 0-dim CPU
scalars), keep their values bit for bit: the resize weight matrices of the
two-view cascade against ``jax.image.resize``, the plane depths against the
reference's ``inverse_depth_samples``, explicit shift tables whatever their
host form, and the guarded depth / disparity conversions against the
reference's at eps, 0, negative, huge and non-finite inputs. (On the card the
same calls are held to "does not wait" in ``tests/test_torch_cuda_kernels.py``.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples as jax_depths
from stereovisionarray_tpu.models.two_view import depth_to_disparity as jax_z2d
from stereovisionarray_tpu.models.two_view import disparity_to_depth as jax_d2z
from stereovisionarray_tpu_torch import config
from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.models import cascade as tcascade
from stereovisionarray_tpu_torch.models.plane_sweep import plane_sweep_volume, translation_shifts
from stereovisionarray_tpu_torch.models.two_view import depth_to_disparity, disparity_to_depth


@pytest.mark.parametrize("m,n", [(17, 68), (68, 17), (135, 540), (192, 768), (1, 4)])
def test_resize_weights_are_jax_resize_of_the_identity(m, n):
    """resize is linear, so jax.image.resize of the identity along an axis is
    its weight matrix (every product is by 0 or 1, every sum exact)."""
    want = np.asarray(jax.jit(lambda e: jax.image.resize(e, (n, m), method="linear"))(
        jnp.eye(m, dtype=jnp.float32))).T
    np.testing.assert_array_equal(tcascade._linear_resize_weights(m, n), want)


@pytest.mark.parametrize("shape,out_shape", [((17, 48), (68, 192)), ((9, 13), (9, 26))])
def test_resize_linear_is_the_two_weight_products(shape, out_shape):
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 90, shape).astype(np.float32))
    want = x
    if out_shape[0] != shape[0]:
        want = torch.from_numpy(tcascade._linear_resize_weights(shape[0], out_shape[0])).T @ want
    want = want @ torch.from_numpy(tcascade._linear_resize_weights(shape[1], out_shape[1]))
    assert torch.equal(tcascade.resize_linear(x, out_shape), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_host_to_device_keeps_values_and_dtype(dtype):
    a = np.random.default_rng(5).uniform(-1e4, 1e4, (3, 5, 2)).astype(dtype)[:, ::2]  # a view
    got = host_to_device(a, "cpu")
    assert got.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
    np.testing.assert_array_equal(got.numpy(), a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    assert host_to_device(t, torch.device("cpu")) is t


def _small_array(num_planes=6):
    cams = reference_rig(rows=3, cols=3, spacing=0.05, resolution=(14, 18))
    images, _ = render_camera_array(cams, (14, 18))
    cfg = config.EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                            "plane_sweep.num_planes": num_planes,
                                            "plane_sweep.topology": "CROSS"})
    return cams, torch.from_numpy(images), cfg.plane_sweep


def test_plane_depths_equal_the_reference():
    cams, images, ps = _small_array()
    _, _, depths = plane_sweep_volume(images, cams, 4, (1, 3, 5, 7), ps, shift_pad=30)
    want = np.asarray(jax_depths(ps.z_near, ps.z_far, ps.num_planes))
    assert depths.dtype == torch.float32
    np.testing.assert_array_equal(depths.numpy(), want)


def test_explicit_shift_tables_in_any_host_form_sweep_alike():
    """numpy float32, a float64 tensor and a float32 tensor of the same
    (exactly representable) shifts give the same volume as the rig's own."""
    cams, images, ps = _small_array()
    depths = np.asarray(jax_depths(ps.z_near, ps.z_far, ps.num_planes))
    sh = translation_shifts(cams, 4, (1, 3, 5, 7), depths)
    runs = [plane_sweep_volume(images, cams, 4, (1, 3, 5, 7), ps, shift_pad=30, shifts=s)[:2]
            for s in (sh, torch.from_numpy(sh).double(), torch.from_numpy(sh))]
    own = plane_sweep_volume(images, cams, 4, (1, 3, 5, 7), ps, shift_pad=30)[:2]
    for vol, nv in runs:
        assert torch.equal(vol, own[0]) and torch.equal(nv, own[1])


_GUARD_INPUTS = np.array([0.0, -0.0, 1e-6, 1e-9, 2e-9, 1.0000001e-6, -3.5, 1e-30, 0.37, 64.0,
                          3e38, np.inf, -np.inf, np.nan], dtype=np.float32)


@pytest.mark.parametrize("port,ref", [(disparity_to_depth, jax_d2z),
                                      (depth_to_disparity, jax_z2d)], ids=["d2z", "z2d"])
@pytest.mark.parametrize("baseline,focal", [(0.12, 700.0), (0.05, 1234.5)])
def test_guarded_inverse_equals_the_reference(port, ref, baseline, focal):
    want = np.asarray(jax.jit(lambda x: ref(x, baseline, focal, -1.0))(_GUARD_INPUTS))
    got = port(torch.from_numpy(_GUARD_INPUTS), baseline, focal, -1.0).numpy()
    np.testing.assert_array_equal(got, want)
