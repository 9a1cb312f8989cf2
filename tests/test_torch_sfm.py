"""The port's SfM layer (geometry/lie.py, sfm/) against the JAX package on
the same numpy inputs, on the CPU.

Each stage is fed the JAX stage's own outputs, so each module is compared on
identical inputs. Tolerances, each about 3x the largest gap measured on the
CPU (the float sums follow PyTorch's order where XLA's is not reproduced):
 - Lie maps: 1e-6 (gap 2.4e-7 near pi, 0 below 1e-4 rad);
 - Harris response, corners, subpixel positions and validity: bit-exact
   (the box filter's cumulative sum in XLA's blocked order, its division as
   a product with the float32 reciprocal, the response as XLA's fused
   multiply-adds); descriptors 2e-6 (gap 4e-7);
 - matching: idx_b and valid exact, score 1e-6;
 - LK: positions 2e-4 px (gap 6e-5 after 5 steps), converged exact;
 - triangulation: points 1e-4 m (gap 2.6e-5 m on 5 cm baselines at 0.1-0.3 m), ok exact;
 - BA and the pose graph: the tolerances in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu import sfm as jsfm
from stereovisionarray_tpu.geometry import lie as jlie
from stereovisionarray_tpu.geometry.camera import make_camera_array
from stereovisionarray_tpu.geometry.camera import translation_only_array as jax_rig
from stereovisionarray_tpu.sfm import features as jfeat
from stereovisionarray_tpu_torch import sfm as tsfm
from stereovisionarray_tpu_torch.evaluation import absolute_trajectory_error
from stereovisionarray_tpu_torch.geometry import camera_array_from_numpy
from stereovisionarray_tpu_torch.geometry import lie as tlie
from stereovisionarray_tpu_torch.sfm import features as tfeat
from stereovisionarray_tpu_torch.sfm.segments import Segments


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_rig(cams):
    return camera_array_from_numpy(*(np.asarray(getattr(cams, f))
                                     for f in ("fx", "fy", "cx", "cy", "R", "t")))


# ---- Lie maps -----------------------------------------------------------------------------

@pytest.mark.parametrize("angle", [1e-8, 1e-6, 1e-4, 1e-2, 0.3, np.pi - 1e-3])
def test_lie_maps_match_reference(angle):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 3))
    w = (d / np.linalg.norm(d, axis=-1, keepdims=True) * angle).astype(np.float32)
    xi = np.concatenate([w, rng.normal(0, 0.1, (64, 3)).astype(np.float32)], -1)
    R_j = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(tlie.so3_exp(_t(w)).numpy(), R_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlie.so3_log(_t(R_j)).numpy(), np.asarray(jlie.so3_log(jnp.asarray(R_j))),
                               rtol=0, atol=1e-6)
    Rs_j, ts_j = jlie.se3_exp(jnp.asarray(xi))
    Rs_t, ts_t = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(Rs_t.numpy(), np.asarray(Rs_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlie.se3_log(_t(Rs_j), _t(ts_j)).numpy(),
                               np.asarray(jlie.se3_log(Rs_j, ts_j)), rtol=0, atol=1e-6)


def test_lie_jacobians_at_zero_are_finite():
    """Forward-mode derivatives through the where-guards at delta = 0, as the
    pose graph takes them: finite, and so3_exp's is the hat basis."""
    zero = torch.zeros(4, 3)
    J = torch.func.jacfwd(tlie.so3_exp)(zero)
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J[0, :, :, 0, 0].numpy(), tlie._hat(torch.eye(3)[0]).numpy())
    R = tlie.so3_exp(torch.full((2, 3), 0.1))
    t = torch.full((2, 3), 0.2)
    for f in (lambda d: tlie.se3_log(tlie.matmul3(tlie.so3_exp(d[:, :3]), R), t + d[:, 3:]),
              lambda d: tlie.so3_log(tlie.so3_exp(d[:, :3])),
              lambda d: tlie.se3_exp(d)[1]):
        assert torch.isfinite(torch.func.jacfwd(f)(torch.zeros(2, 6))).all()


# ---- features, matching, LK ---------------------------------------------------------------

def _corner_image(h=96, w=128, seed=0):
    """tests/test_sfm.py's blobby texture with bright squares."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(90, 110, size=(h, w)).astype(np.float32)
    for y in range(16, h - 16, 24):
        for x in range(16, w - 16, 24):
            img[y:y + 8, x:x + 8] += 120.0
    return img


@pytest.fixture(scope="module")
def views():
    """Four views: the corner image, shifted copies, and a rendered view."""
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array

    img = _corner_image()
    rendered = render_camera_array(reference_rig(rows=1, cols=2, resolution=(96, 128)),
                                   (96, 128))[0]
    return np.stack([img, np.roll(img, 6, axis=1), np.roll(img, -3, axis=0), *rendered])


@pytest.fixture(scope="module")
def jax_features(views):
    return [jsfm.extract_features(jnp.asarray(v), max_features=128) for v in views]


def test_harris_response_is_bit_exact(views):
    got = tfeat.harris_response(_t(views)).numpy()
    for v, g in zip(views, got):
        np.testing.assert_array_equal(g, np.asarray(jax.jit(jfeat.harris_response)(jnp.asarray(v))))


@pytest.mark.parametrize("max_features", [128, 512])
def test_detect_features_is_bit_exact(views, max_features):
    """512 exceeds the corners that survive NMS: the -inf slots tie, and the
    stable sort orders them as lax.top_k does."""
    uv, resp, ok = tfeat.detect_features(_t(views), max_features=max_features)
    for i, v in enumerate(views):
        want = jsfm.detect_features(jnp.asarray(v), max_features=max_features)
        np.testing.assert_array_equal(uv[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(resp[i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(want[2]))
    assert (~ok).any()


def test_descriptors_match_reference(views, jax_features):
    uv = np.stack([np.asarray(f.uv) for f in jax_features])
    got = tsfm.describe_patches(_t(views), _t(uv)).numpy()
    want = np.stack([np.asarray(f.descriptor) for f in jax_features])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    f = tsfm.extract_features(_t(views[0]), max_features=128)
    norms = torch.linalg.vector_norm(f.descriptor, dim=-1)[f.valid]
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def test_matching_matches_reference(jax_features):
    """Every view against view 0, batched; the JAX descriptors on both sides."""
    fa = jax_features[0]
    desc = np.stack([np.asarray(f.descriptor) for f in jax_features])
    ok = np.stack([np.asarray(f.valid) for f in jax_features])
    m = tsfm.match_descriptors(_t(fa.descriptor), _t(desc), _t(fa.valid), _t(ok))
    for i, f in enumerate(jax_features):
        want = jsfm.match_descriptors(fa.descriptor, f.descriptor, fa.valid, f.valid)
        np.testing.assert_array_equal(m.idx_b[i].numpy(), np.asarray(want.idx_b))
        np.testing.assert_array_equal(m.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(m.idx_a[i].numpy(), np.asarray(want.idx_a))
        np.testing.assert_allclose(m.score[i].numpy(), np.asarray(want.score), rtol=0, atol=1e-6)
    assert m.valid[1].sum() > 20


def test_lk_refine_matches_reference(views):
    """Matches perturbed by up to 1.5 px, plus a few far off (not converged)."""
    rng = np.random.default_rng(3)
    ref_uv = rng.uniform(16, 80, (40, 2)).astype(np.float32)
    uv = (ref_uv + rng.uniform(-1.5, 1.5, (3, 40, 2))).astype(np.float32)
    uv[:, :3] += 6.0
    imgs = np.stack([views[0], views[0], views[3]])
    got_uv, got_ok = tsfm.lk_refine(_t(views[0]), _t(ref_uv), _t(imgs), _t(uv))
    for i in range(3):
        want_uv, want_ok = jsfm.lk_refine(jnp.asarray(views[0]), jnp.asarray(ref_uv),
                                          jnp.asarray(imgs[i]), jnp.asarray(uv[i]))
        np.testing.assert_array_equal(got_ok[i].numpy(), np.asarray(want_ok))
        np.testing.assert_allclose(got_uv[i].numpy(), np.asarray(want_uv), rtol=0, atol=2e-4)
    # the same image: the perturbation is undone
    err = np.abs(got_uv[0].numpy() - ref_uv)[got_ok[0].numpy()]
    assert np.median(err) < 0.05


# ---- triangulation, BA, pose graph -----------------------------------------------------------

def _rig_and_points(n_pts=64, seed=0):
    """tests/test_sfm.py's 5-camera mini-rig and random points in front of it."""
    rng = np.random.default_rng(seed)
    pos = np.array([[0, 0, -0.75], [0.05, 0, -0.75], [0, 0.05, -0.75], [-0.05, 0, -0.75],
                    [0, -0.05, -0.75]], dtype=np.float32)
    cams = jax_rig(0.05, pos, 0.036 / 360, resolution=(270, 360))
    X = np.stack([rng.uniform(-0.08, 0.08, n_pts), rng.uniform(-0.08, 0.08, n_pts),
                  rng.uniform(0.1, 0.3, n_pts)], axis=-1).astype(np.float32)
    cam_idx = np.repeat(np.arange(len(cams)), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), len(cams)).astype(np.int32)
    uv, _ = cams[jnp.asarray(cam_idx)].project_each(jnp.asarray(X)[jnp.asarray(pt_idx)])
    return cams, X, cam_idx, pt_idx, np.asarray(uv)


def test_camera_helpers_match_reference():
    """pixel_rays, project_each, rays_each, world_to_cam_each, relative_pose
    on a rotated rig: rays and camera-frame points 2e-7 (gap 6e-8), pixels
    5e-5 px (gap 1.5e-5), the relative pose 4e-7 (gap 1.2e-7)."""
    rng = np.random.default_rng(2)
    cams, X, cam_idx, pt_idx, _ = _rig_and_points()
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.05, (5, 3)).astype(np.float32))))
    jc = make_camera_array(cams.fx, cams.fy, cams.cx, cams.cy, R @ np.asarray(cams.R), cams.t)
    tc = _port_rig(jc)
    uv = rng.uniform(0, 300, (5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(tc.pixel_rays(_t(uv)).numpy(), np.asarray(jc.pixel_rays(jnp.asarray(uv))),
                               rtol=0, atol=2e-7)
    one = tc[2]
    np.testing.assert_allclose(one.pixel_rays(_t(uv[0])).numpy(),
                               np.asarray(jc[2].pixel_rays(jnp.asarray(uv[0]))), rtol=0, atol=2e-7)
    ci, pts = cam_idx[::7], X[pt_idx[::7]]
    tsub, jsub = tc[ci], jc[jnp.asarray(ci)]
    np.testing.assert_allclose(tsub.world_to_cam_each(_t(pts)).numpy(),
                               np.asarray(jsub.world_to_cam_each(jnp.asarray(pts))), rtol=0, atol=2e-7)
    for a, b in zip(tsub.project_each(_t(pts)), jsub.project_each(jnp.asarray(pts))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-5)
    uv_each = rng.uniform(0, 300, (len(ci), 2)).astype(np.float32)
    np.testing.assert_allclose(tsub.rays_each(_t(uv_each)).numpy(),
                               np.asarray(jsub.rays_each(jnp.asarray(uv_each))), rtol=0, atol=2e-7)
    for a, b in zip(tc.relative_pose(1, 3), jc.relative_pose(1, 3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=4e-7)


def test_segment_sums_are_the_segment_sums():
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 7, 200)  # -1: dropped, as segment_sum drops it
    x = rng.normal(size=(200, 2, 3)).astype(np.float32)
    got = Segments(ids, 6, "cpu").sum(_t(x)).numpy()  # 6: id 6 dropped too
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=6))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_triangulation_matches_reference():
    cams, X, cam_idx, pt_idx, uv = _rig_and_points()
    uv = uv + np.random.default_rng(1).normal(0, 0.3, uv.shape).astype(np.float32)
    valid = np.ones(len(cam_idx), bool)
    valid[cam_idx == 0] = False
    valid[(pt_idx < 4) & (cam_idx > 1)] = False  # points 0-3: a single ray
    want_X, want_ok = jsfm.triangulate_midpoint(cams, jnp.asarray(cam_idx), jnp.asarray(uv),
                                                jnp.asarray(valid), X.shape[0], jnp.asarray(pt_idx))
    got_X, got_ok = tsfm.triangulate_midpoint(_port_rig(cams), cam_idx, _t(uv), _t(valid),
                                              X.shape[0], pt_idx)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok[:4].any() and got_ok[4:].all()
    ok = got_ok.numpy()
    err = np.abs(got_X.numpy() - np.asarray(want_X))[ok]
    assert err.max() <= 1e-4, err.max()
    r_j = np.asarray(jsfm.reprojection_errors(cams, want_X, jnp.asarray(cam_idx),
                                              jnp.asarray(pt_idx), jnp.asarray(uv)))
    r_t = tsfm.reprojection_errors(_port_rig(cams), _t(want_X), cam_idx, pt_idx, _t(uv)).numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=2e-4)


def _perturbed(cams, X, rng, rot=0.01, trans=0.005, pts=0.01):
    n = len(cams)
    dw = rng.normal(0, rot, (n, 3)).astype(np.float32)
    dw[0] = 0
    dR = np.asarray(jlie.so3_exp(jnp.asarray(dw)))
    R = dR @ np.asarray(cams.R)
    t = np.einsum("nij,nj->ni", dR, np.asarray(cams.t)) + rng.normal(0, trans, (n, 3)).astype(np.float32)
    t[0] = np.asarray(cams.t)[0]
    bad = make_camera_array(cams.fx, cams.fy, cams.cx, cams.cy, R, t)
    return bad, (X + rng.normal(0, pts, X.shape)).astype(np.float32)


@pytest.mark.parametrize("kernel,outliers,tol_c,tol_x", [
    ("huber", False, 2e-7, 2e-5), ("tukey", True, 1.5e-6, 2e-4), ("cauchy", True, 5e-5, 1.2e-2)])
def test_bundle_adjust_matches_reference(kernel, outliers, tol_c, tol_x):
    """The same perturbed start on both sides; tests/test_sfm.py's setups
    (with outliers: 10% of the observations moved 30-80 px). Gaps measured
    (camera centres, points): huber 6e-8 / 6.6e-6, tukey 4.2e-7 / 6.8e-5,
    cauchy 1.4e-5 / 3.7e-3 m (its outliers keep weight, so the points they
    touch sit in flat directions); the cost trajectories agree to 3e-3
    relative while above 1e-4 (gap 1.1e-3; below it both are float noise)."""
    rng = np.random.default_rng(7)
    cams, X, cam_idx, pt_idx, uv = _rig_and_points()
    bad, X_bad = _perturbed(cams, X, rng)
    if outliers:
        idx = rng.choice(len(uv), len(uv) // 10, replace=False)
        uv = uv.copy()
        uv[idx] += rng.uniform(30, 80, (len(idx), 2)).astype(np.float32)
    uv_c = (uv - np.stack([np.asarray(cams.cx)[cam_idx], np.asarray(cams.cy)[cam_idx]], -1))
    uv_c = uv_c.astype(np.float32)
    valid = np.ones(len(cam_idx), bool)
    want = jsfm.bundle_adjust(bad, jnp.asarray(X_bad),
                              jsfm.BAProblem(jnp.asarray(cam_idx), jnp.asarray(pt_idx),
                                             jnp.asarray(uv_c), jnp.asarray(valid)),
                              iterations=15, damping=1e-4, kernel=kernel)
    got = tsfm.bundle_adjust(_port_rig(bad), _t(X_bad),
                             tsfm.BAProblem(cam_idx, pt_idx, _t(uv_c), _t(valid)),
                             iterations=15, damping=1e-4, kernel=kernel)
    np.testing.assert_allclose(got.cameras.centers.numpy(), np.asarray(want.cameras.centers),
                               rtol=0, atol=tol_c)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=tol_x)
    c_t, c_j = got.cost.numpy(), np.asarray(want.cost)
    big = c_j > 1e-4
    np.testing.assert_allclose(c_t[big], c_j[big], rtol=3e-3)
    assert (c_t[~big] < 1e-4).all()
    ate = float(absolute_trajectory_error(got.cameras.centers, _t(cams.centers), align_scale=True))
    assert ate < 1e-4, ate
    with pytest.raises(ValueError):
        tsfm.bundle_adjust(_port_rig(bad), _t(X_bad), tsfm.BAProblem(cam_idx, pt_idx, _t(uv_c),
                                                                     _t(valid)), kernel="l2")


def _graph(rng, n=9, rot=0.05, trans=0.2, noise=(0.05, 0.05)):
    """tests/test_sfm.py's ring of relative poses and a noisy start."""
    w_true = rng.normal(0, rot, (n, 3)).astype(np.float32)
    R_true = np.asarray(jlie.so3_exp(jnp.asarray(w_true))).copy()
    t_true = rng.normal(0, trans, (n, 3)).astype(np.float32)
    R_true[0], t_true[0] = np.eye(3), 0
    ei = np.array(list(range(n - 1)) + [n - 1], dtype=np.int32)
    ej = np.array(list(range(1, n)) + [0], dtype=np.int32)
    R_rel = np.einsum("eik,ejk->eij", R_true[ej], R_true[ei])
    t_rel = t_true[ej] - np.einsum("eij,ej->ei", R_rel, t_true[ei])
    dw = rng.normal(0, noise[0], (n, 3)).astype(np.float32)
    dw[0] = 0
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(dw))) @ R_true
    t0 = (t_true + rng.normal(0, noise[1], (n, 3))).astype(np.float32)
    t0[0] = 0
    return (ei, ej, R_rel.astype(np.float32), t_rel.astype(np.float32), np.ones(len(ei), np.float32),
            R0.astype(np.float32), t0, R_true, t_true)


@pytest.mark.parametrize("seed", [0, 3])
def test_pose_graph_matches_reference(seed):
    ei, ej, R_rel, t_rel, wts, R0, t0, R_true, t_true = _graph(np.random.default_rng(seed))
    R_j, t_j, c_j = jsfm.pose_graph_optimize(
        jnp.asarray(R0), jnp.asarray(t0),
        jsfm.PoseGraph(*(jnp.asarray(a) for a in (ei, ej, R_rel, t_rel, wts))), iterations=10)
    R_t, t_t, c_t = tsfm.pose_graph_optimize(
        _t(R0), _t(t0), tsfm.PoseGraph(*(_t(a) for a in (ei, ej, R_rel, t_rel, wts))),
        iterations=10)
    assert torch.isfinite(c_t).all() and c_t[-1] < 1e-5
    # gaps 1.8e-7 (R) and 3e-8 (t); the costs agree to 4e-7 relative over
    # the first two steps, then both sit at float noise (< 3e-8)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R_t.numpy(), R_true, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), t_true, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c_t[:2].numpy(), np.asarray(c_j)[:2], rtol=1e-5)
