"""The port's fusion path (ops/warp.splat_depth, geometry/pointcloud.py,
geometry/cloudops.py, models/fusion.py) against the JAX package on the same
numpy inputs, on the CPU.

Tolerances: splat_depth, the point-cloud converters and the cloudops copy
are bit-exact. fuse_depth_maps: at least 99.9% of `valid` and of `support`
agree (the agreement test can flip at near-ties under another float order;
on the 3x3 rig all of them agree), and where both keep a pixel the fused
depth is within 1e-6 relative and the point within 1e-6 m. Normals within
1e-6 and their valid maps equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.datasets.synthetic import SceneSpec
from stereovisionarray_tpu.datasets.synthetic import reference_rig as jax_rig
from stereovisionarray_tpu.datasets.synthetic import render_camera_array as jax_render
from stereovisionarray_tpu.geometry import cloudops as jco
from stereovisionarray_tpu.geometry import pointcloud as jpc
from stereovisionarray_tpu.models import fusion as jfu
from stereovisionarray_tpu.ops import warp as jw
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.geometry import cloudops as tco
from stereovisionarray_tpu_torch.geometry import pointcloud as tpc
from stereovisionarray_tpu_torch.models import array_depth_pipeline
from stereovisionarray_tpu_torch.models import fusion as tfu
from stereovisionarray_tpu_torch.ops import warp as tw

RES = (48, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs six workers
    on the machine's cores, and ops split over every core in each worker
    oversubscribe them (a pipeline call then ran a hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rigs():
    """The 3x3 rig (tests/test_fusion.py:18-25) on both sides, and its exact
    depths (equal on both sides)."""
    jc = jax_rig(rows=3, cols=3, spacing=0.05, resolution=RES)
    tc = reference_rig(rows=3, cols=3, spacing=0.05, resolution=RES)
    _, depths = render_camera_array(tc, RES)
    assert np.array_equal(np.asarray(jax_render(jc, RES, SceneSpec())[1]), depths)
    return jc, tc, depths


@pytest.mark.parametrize("seed", range(3))
def test_splat_depth_is_bit_exact(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 1.0, RES).astype(np.float32)
    d[rng.uniform(size=RES) < 0.1] = 0.0
    shift = rng.normal(0, 3, RES + (2,)).astype(np.float32)
    shift[:6, :6] = 0.5  # exact halves: round half to even
    want = np.asarray(jw.splat_depth(jnp.asarray(d), jnp.asarray(shift), fill=-1.0))
    got = tw.splat_depth(torch.from_numpy(d), torch.from_numpy(shift), fill=-1.0).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("view", [0, 4, 8])
def test_point_cloud_converters_are_bit_exact(rigs, view):
    jc, tc, depths = rigs
    rng = np.random.default_rng(view)
    d = depths[view].copy()
    mask = rng.uniform(size=RES) > 0.05
    pj, vj = jpc.depth_map_to_points(jc[view], jnp.asarray(d), jnp.asarray(mask))
    pt, vt = tpc.depth_map_to_points(tc[view], torch.from_numpy(d), torch.from_numpy(mask))
    assert np.array_equal(pt.numpy(), np.asarray(pj)) and np.array_equal(vt.numpy(),
                                                                          np.asarray(vj))
    pts = rng.uniform([-0.3, -0.2, -0.5], [0.3, 0.2, 1.2], (5000, 3)).astype(np.float32)
    valid = rng.uniform(size=5000) > 0.1
    want = np.asarray(jpc.points_to_depth_map(jc[view], jnp.asarray(pts), RES,
                                              valid=jnp.asarray(valid), fill=-1.0))
    got = tpc.points_to_depth_map(tc[view], torch.from_numpy(pts), RES,
                                  valid=torch.from_numpy(valid), fill=-1.0).numpy()
    assert np.array_equal(got, want) and (got > 0).any()
    img = rng.uniform(-20, 300, RES).astype(np.float32)
    assert np.array_equal(tpc.point_cloud_colors(torch.from_numpy(img), vt).numpy(),
                          np.asarray(jpc.point_cloud_colors(jnp.asarray(img), vj)))


@pytest.mark.parametrize("voxel", [0.02, 0.05])
def test_cloudops_copy_is_exact(voxel):
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(0, 0.3, (4000, 3)),
                          rng.uniform(2, 3, (30, 3))]).astype(np.float32)  # isolated speckle
    w = rng.uniform(0.1, 1, len(pts))
    attr = rng.uniform(0, 255, (len(pts), 3))
    for got, want in zip(tco.voxel_downsample(pts, voxel, w, attr),
                         jco.voxel_downsample(pts, voxel, w, attr)):
        assert np.array_equal(got, want)
    for got, want in zip(tco.remove_outliers(pts, voxel, 4), jco.remove_outliers(pts, voxel, 4)):
        assert np.array_equal(got, want)


def _agreement(got, want):
    """(share of valid equal, share of support equal, max rel depth gap
    where both keep, max point gap where both keep)."""
    vg, vw = got.valid.numpy(), np.asarray(want.valid)
    both = vg & vw
    dg, dw = got.depth.numpy(), np.asarray(want.depth)
    return ((vg == vw).mean(), (got.support.numpy() == np.asarray(want.support)).mean(),
            (np.abs(dg - dw)[both] / dw[both]).max(),
            np.abs(got.points.numpy() - np.asarray(want.points))[both].max())


@pytest.mark.parametrize("kw", [dict(), dict(dedup=False), dict(average=False),
                                dict(min_support=2, rel_thresh=0.005)])
def test_fuse_depth_maps_matches_reference(rigs, kw):
    jc, tc, depths = rigs
    want = jfu.fuse_depth_maps(jc, jnp.asarray(depths), **kw)
    got = tfu.fuse_depth_maps(tc, torch.from_numpy(depths), **kw)
    valid_share, support_share, depth_gap, point_gap = _agreement(got, want)
    assert valid_share >= 0.999 and support_share >= 0.999
    assert depth_gap <= 1e-6 and point_gap <= 1e-6
    assert np.array_equal(got.confidence.numpy() > 0, got.valid.numpy())


def test_fuse_rejects_a_corrupt_view_and_respects_valid(rigs):
    jc, tc, depths = rigs
    bad = depths.copy()
    bad[0] *= 1.3
    valid = np.ones(depths.shape, bool)
    valid[:, :, :8] = False
    want = jfu.fuse_depth_maps(jc, jnp.asarray(bad), jnp.asarray(valid), dedup=False)
    got = tfu.fuse_depth_maps(tc, torch.from_numpy(bad), torch.from_numpy(valid), dedup=False)
    valid_share, support_share, depth_gap, _ = _agreement(got, want)
    assert valid_share >= 0.999 and support_share >= 0.999 and depth_gap <= 1e-6
    assert got.valid[0].float().mean() < 0.01 and not got.valid[:, :, :8].any()
    pts, conf, col = tfu.fused_point_cloud(got, torch.ones(depths.shape))
    assert pts.shape == (int(got.valid.sum()), 3) and conf.shape == col.shape


@pytest.mark.parametrize("view", [0, 4])
def test_depth_normals_match_reference(rigs, view):
    jc, tc, depths = rigs
    valid = depths[view] > 0.6
    nj, okj = jfu.depth_normals(jc[view], jnp.asarray(depths[view]), jnp.asarray(valid))
    nt, okt = tfu.depth_normals(tc[view], torch.from_numpy(depths[view]),
                                torch.from_numpy(valid))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


def test_reconstruct_array_fuses_the_pipeline_depths(rigs):
    """reconstruct_array on the 3x3 rig: each view's depth is a direct
    array_depth_pipeline call with that reference, and the fused result is
    the reference's fuse_depth_maps on those depths."""
    jc, tc, _ = rigs
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.num_planes": 32, "refine.radius": 2,
                                     "refine.window": 9, "sgm.num_paths": 4})
    images = torch.from_numpy(render_camera_array(tc, RES)[0])
    views = (0, 4, 8)
    result, depths = tfu.reconstruct_array(images, tc, cfg, views, min_confidence=0.05)
    outs = [array_depth_pipeline(images, tc, cfg, ref_index=ref) for ref in views]
    assert all(torch.equal(d, out.refined_depth) for d, out in zip(depths, outs))
    valids = torch.stack([out.valid & (out.sweep.confidence >= 0.05) for out in outs])
    want = jfu.fuse_depth_maps(jc[jnp.asarray(views)], jnp.asarray(depths.numpy()),
                               valid=jnp.asarray(valids.numpy()))
    valid_share, support_share, depth_gap, point_gap = _agreement(result, want)
    assert valid_share >= 0.999 and support_share >= 0.999
    assert depth_gap <= 1e-6 and point_gap <= 1e-6
    assert result.valid.sum() > 0.2 * result.valid.numel()
