"""The port's rig state, plane depths, shifts, renderer and warps against the
JAX reference: topology pairs, CameraArray fields, inverse_depth_samples,
translation_shifts and render_camera_array bit for bit (np.array_equal); the
float geometry and warps within float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.datasets import SceneSpec as JaxScene
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu.datasets import render_camera_array as jax_render
from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples as jax_depths
from stereovisionarray_tpu.geometry.topology import PairTopology as JaxTopology
from stereovisionarray_tpu.geometry.topology import camera_pairs as jax_pairs
from stereovisionarray_tpu.geometry.topology import grid_positions as jax_grid
from stereovisionarray_tpu.models.plane_sweep import translation_shifts as jax_shifts
from stereovisionarray_tpu.ops import warp as jax_warp
from stereovisionarray_tpu_torch.datasets.synthetic import (
    SceneSpec,
    reference_rig,
    render_camera_array,
)
from stereovisionarray_tpu_torch.geometry import (
    PairTopology,
    camera_array_from_numpy,
    camera_pairs,
    grid_positions,
    inverse_depth_samples,
)
from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts
from stereovisionarray_tpu_torch.ops import warp

H, W = 48, 64
FIELDS = ("fx", "fy", "cx", "cy", "R", "t")
SLANTS = dict(slants=((-0.08, 0.0, -0.06, 0.02, 0.12, 0.4, -0.2),),
              textureless=((0.02, 0.08, -0.04, 0.03, 0.1),))


@pytest.mark.parametrize("topology", [t.value for t in JaxTopology])
@pytest.mark.parametrize("rows,cols,center", [(5, 5, None), (3, 3, None), (4, 6, 9), (5, 5, 0)])
def test_topology_pairs_equal(topology, rows, cols, center):
    got = camera_pairs(PairTopology(topology.upper()), rows, cols, center)
    want = jax_pairs(JaxTopology(topology), rows, cols, center)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_grid_positions_equal():
    for args in ((5, 5, 0.05, (-0.1, -0.1), -0.75), (3, 4, 0.03, (0.2, -0.1), 0.5)):
        assert np.array_equal(grid_positions(*args), jax_grid(*args))


@pytest.mark.parametrize("rows,res", [(3, (H, W)), (5, (270, 360))])
def test_camera_array_fields_equal(rows, res):
    got, want = reference_rig(rows=rows, cols=rows, resolution=res), jax_rig(rows=rows, cols=rows,
                                                                              resolution=res)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == np.float32 and np.array_equal(a, b), f
    assert np.array_equal(got.centers.numpy(), np.asarray(want.centers))
    assert np.array_equal(got.K.numpy(), np.asarray(want.K))
    assert len(got) == rows * rows and got[2].fx.shape == ()


def test_camera_array_from_numpy_round_trips_a_general_rig():
    r = np.random.default_rng(3)
    from stereovisionarray_tpu.geometry.camera import look_at_rotation, make_camera_array

    eyes = r.uniform(-0.2, 0.2, (4, 3)) + [0, 0, -0.8]
    R = np.stack([np.asarray(look_at_rotation(e, (0.0, 0.0, 0.2))) for e in eyes])
    t = -np.einsum("nij,nj->ni", R, eyes)
    want = make_camera_array(r.uniform(400, 600, 4), r.uniform(400, 600, 4), r.uniform(150, 200, 4),
                             r.uniform(100, 150, 4), R, t)
    got = camera_array_from_numpy(*(np.asarray(getattr(want, f)) for f in FIELDS))
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    pts = r.uniform(-0.2, 0.2, (4, 10, 3)).astype(np.float32) + np.float32([0, 0, 0.3])
    uv, z = got.project(torch.from_numpy(pts))
    uv_j, z_j = want.project(jnp.asarray(pts))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-5)
    back = got.backproject(uv, z)
    np.testing.assert_allclose(back.numpy(), np.asarray(want.backproject(uv_j, z_j)), atol=1e-4)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)
    depths = np.float32([0.4, 0.7, 1.1])
    Hs = got.fronto_plane_homography(1, [0, 2, 3], torch.from_numpy(depths))
    Hs_want = want.fronto_plane_homography(1, jnp.asarray([0, 2, 3]), jnp.asarray(depths))
    np.testing.assert_allclose(Hs.numpy(), np.asarray(Hs_want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("z_near,z_far", [(0.55, 1.1), (0.3, 2.0), (0.1, 10.0)])
@pytest.mark.parametrize("num", [1, 2, 8, 16, 24, 48, 96, 97, 128, 256])
def test_inverse_depth_samples_bit_equal(z_near, z_far, num):
    got = inverse_depth_samples(z_near, z_far, num)
    assert got.dtype == np.float32
    assert np.array_equal(got, np.asarray(jax_depths(z_near, z_far, num)))


@pytest.mark.parametrize("rows,topology,ref", [(3, "CROSS", 4), (5, "TO_CENTER", 12),
                                               (5, "CROSS", 7)])
@pytest.mark.parametrize("num", [16, 128])
def test_translation_shifts_bit_equal(rows, topology, ref, num):
    cams, jcams = reference_rig(rows=rows, cols=rows, resolution=(H, W)), jax_rig(
        rows=rows, cols=rows, resolution=(H, W))
    src = [int(b) for a, b in jax_pairs(JaxTopology(topology.lower()), rows, rows, ref) if a == ref]
    depths = inverse_depth_samples(0.55, 1.1, num)
    got = translation_shifts(cams, ref, src, depths)
    want = np.asarray(jax_shifts(jcams, ref, jnp.asarray(src), jnp.asarray(depths)))
    assert got.shape == (len(src), num, 2) and got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scene", [dict(), SLANTS])
def test_render_camera_array_bit_equal(scene):
    images, depths = render_camera_array(reference_rig(rows=3, cols=3, resolution=(H, W)), (H, W),
                                         SceneSpec(**scene))
    want_i, want_d = jax_render(jax_rig(rows=3, cols=3, resolution=(H, W)), (H, W),
                                JaxScene(**scene))
    assert images.dtype == np.float32 and depths.dtype == np.float32
    assert np.array_equal(images, want_i) and np.array_equal(depths, want_d)
    assert images.shape == (9, H, W) and not np.array_equal(images[0], np.round(images[0]))


def test_warps_match_reference():
    r = np.random.default_rng(1)
    img = r.uniform(0, 255, (H, W)).astype(np.float32)
    coords = r.uniform(-3, W + 3, (20, 30, 2)).astype(np.float32)
    coords[..., 1] *= H / W
    coords[0, :4] = [[0, 0], [W - 1, H - 1], [W - 1, 0.5], [-0.0, H - 1]]  # exact borders
    v, ok = warp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords), fill=-1.0)
    vj, okj = jax_warp.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=-1.0)
    assert np.array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-4)

    Hm = np.float32([[1.02, 0.01, -3.5], [-0.02, 0.98, 2.25], [1e-4, -2e-4, 1.0]])
    w_, ok = warp.homography_warp(torch.from_numpy(img), torch.from_numpy(Hm))
    wj, okj = jax_warp.homography_warp(jnp.asarray(img), jnp.asarray(Hm))
    assert (ok.numpy() != np.asarray(okj)).mean() < 1e-3
    both = ok.numpy() & np.asarray(okj)
    np.testing.assert_allclose(w_.numpy()[both], np.asarray(wj)[both], atol=1e-2)

    disp = r.uniform(-1, 12, (H, W)).astype(np.float32)
    b = np.float32([0.6, -0.8])
    w_, ok = warp.warp_with_disparity(torch.from_numpy(img), torch.from_numpy(disp), b)
    wj, okj = jax_warp.warp_with_disparity(jnp.asarray(img), jnp.asarray(disp), jnp.asarray(b))
    assert np.array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(w_.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-4)
