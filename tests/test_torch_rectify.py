"""The port's lens distortion (geometry/distortion.py), rectification
(geometry/rectify.py), look_at_rotation and ATE against the JAX package on
the same numpy inputs, on the CPU, and tests/test_distortion.py's and
tests/test_rectify.py's checks through the port.

Bit-exact: distorted points, undistorted images (same input), validity
maps, look_at_rotation. Tolerances, each about 3x the largest gap measured
on the CPU: undistorted points 1e-7 (gap 3e-8: the reference's fixed-point
loop is compiled, and XLA contracts its multiply-adds); distorted images
1.5e-4 on 0-255 values (gap 4.6e-5: sample coordinates an ulp apart, times
the gradient); rectified images 7e-4 (gap 2.2e-4); rectifying homographies
2.5e-6 relative to their largest entry (gap 7.9e-7); ATE 7e-8 m (gap 2.2e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.evaluation.metrics import absolute_trajectory_error as jax_ate
from stereovisionarray_tpu.geometry import distortion as jdist
from stereovisionarray_tpu.geometry import look_at_rotation as jax_look_at
from stereovisionarray_tpu.geometry import make_camera_array as jax_make_rig
from stereovisionarray_tpu.geometry import rectify as jrect
from stereovisionarray_tpu.geometry.camera import translation_only_array as jax_toa
from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
from stereovisionarray_tpu_torch.datasets.synthetic import SceneSpec, reference_rig, render_view
from stereovisionarray_tpu_torch.evaluation import absolute_trajectory_error
from stereovisionarray_tpu_torch.geometry import (
    Distortion,
    camera_array_from_numpy,
    distort_image,
    distort_points,
    look_at_rotation,
    rectified_disparity_to_depth,
    rectify_images,
    rectify_pair,
    translation_only_array,
    undistort_image,
    undistort_points,
)
from stereovisionarray_tpu_torch.models import two_view_disparity

DIST = Distortion(k1=-0.25, k2=0.08, p1=0.001, p2=-0.002)
JDIST = jdist.Distortion(*DIST)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _single_cam(h, w):
    pos = np.zeros((1, 3), np.float32)
    return (translation_only_array(0.05, pos, 0.036 / w, resolution=(h, w))[0],
            jax_toa(0.05, pos, 0.036 / w, resolution=(h, w))[0])


# ---- distortion ---------------------------------------------------------------------------

def test_points_match_reference_and_round_trip():
    xy = np.random.default_rng(0).uniform(-0.5, 0.5, (500, 2)).astype(np.float32)
    d_t = distort_points(_t(xy), DIST)
    np.testing.assert_array_equal(d_t.numpy(),
                                  np.asarray(jdist.distort_points(jnp.asarray(xy), JDIST)))
    u_t = undistort_points(d_t, DIST)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(jdist.undistort_points(jnp.asarray(d_t.numpy()),
                                                                              JDIST)),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(u_t.numpy(), xy, atol=2e-6)  # tests/test_distortion.py's bound
    grid = _t(np.linspace(-1, 1, 20, dtype=np.float32).reshape(10, 2))
    assert torch.equal(distort_points(grid, Distortion()), grid)
    barrel = distort_points(_t([[0.4, 0.3]]), Distortion(k1=-0.3))
    assert torch.linalg.vector_norm(barrel) < 0.5


def test_images_match_reference_and_batch_over_views():
    """One camera against the reference; an (N,) rig with (N, H, W) images
    in one pass equals the per-view calls bit for bit."""
    h, w = 64, 96
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (100.0 + 60.0 * np.sin(u / 9.0) + 50.0 * np.cos(v / 7.0)).astype(np.float32)
    cam, jcam = _single_cam(h, w)
    d_t, dv_t = distort_image(_t(img), cam, DIST)
    d_j, dv_j = jdist.distort_image(jnp.asarray(img), jcam, JDIST)
    np.testing.assert_array_equal(dv_t.numpy(), np.asarray(dv_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1.5e-4)
    u_t, uv_t = undistort_image(d_t, cam, DIST)
    u_j, uv_j = jdist.undistort_image(jnp.asarray(d_t.numpy()), jcam, JDIST)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    # tests/test_distortion.py's round trip
    inner = np.s_[8:-8, 8:-8]
    assert uv_t.numpy()[inner].all()
    err = np.abs(u_t.numpy() - img)[inner]
    assert np.median(err) < 0.5 and err.max() < 6.0
    # batched over a rig of views with their own principal points
    rig = reference_rig(rows=1, cols=3, resolution=(h, w))
    host = rig.host()
    rig = camera_array_from_numpy(host.fx, host.fy, host.cx + np.array([0.0, 3.5, -2.0], np.float32),
                                  host.cy, host.R, host.t)
    stack = _t(np.stack([img, img[::-1].copy(), img[:, ::-1].copy()]))
    for fn in (undistort_image, distort_image):
        got, ok = fn(stack, rig, DIST)
        for i in range(3):
            one, one_ok = fn(stack[i], rig[i], DIST)
            assert torch.equal(got[i], one) and torch.equal(ok[i], one_ok)


def test_undistortion_flattens_the_disparity_field():
    """tests/test_distortion.py's end-to-end story through the port: a shared
    lens bends a flat plane's disparity field, ingest undistortion flattens
    it back."""
    r = np.random.default_rng(2)
    h, w, d_true, D = 80, 160, 10, 24
    strong = Distortion(k1=-0.35, k2=0.1)
    p = np.pad(r.uniform(0, 255, (h, w + d_true)).astype(np.float32), 1, mode="edge")
    base = sum(p[i:i + h, j:j + w + d_true] for i in range(3) for j in range(3)) / 9.0
    left, right = _t(base[:, :w]), _t(base[:, d_true:])
    cam, _ = _single_cam(h, w)
    dl, dr = distort_image(left, cam, strong)[0], distort_image(right, cam, strong)[0]
    (ul, valid_l), ur = undistort_image(dl, cam, strong), undistort_image(dr, cam, strong)[0]
    ccfg = CostConfig(num_disparities=D, census_window=(5, 5))
    scfg = SGMConfig(num_paths=4, uniqueness=0.0, lr_max_diff=0.0)

    def dev95(a, b):
        out = two_view_disparity(a, b, ccfg, scfg, backend="xla")
        dd = out.disparity.numpy()[8:-8, D + 4:-8]
        return float(np.percentile(np.abs(dd - d_true), 95))

    e_clean, e_dist, e_und = dev95(left, right), dev95(dl, dr), dev95(ul, ur)
    assert e_clean < 0.35
    assert e_dist > 2.5 * e_clean and e_dist > 0.6, (e_dist, e_clean)
    assert e_und < 1.5 * e_clean + 0.1, (e_und, e_clean)
    assert valid_l.numpy()[8:-8, 8:-8].mean() > 0.95


# ---- rectification ------------------------------------------------------------------------

def _verged_pair(baseline=0.2, depth=2.0, res=(240, 320), f=300.0):
    """Two cameras toeing in toward a common target (tests/test_rectify.py),
    on both sides from the same numpy fields."""
    h, w = res
    eyes = np.asarray([[-baseline / 2, 0.0, 0.0], [baseline / 2, 0.0, 0.0]])
    target = np.asarray([0.0, 0.0, depth])
    R = np.stack([look_at_rotation(e, target).numpy() for e in eyes])
    t = np.einsum("nij,nj->ni", R, -eyes).astype(np.float32)
    fields = (np.full(2, f, np.float32), np.full(2, f, np.float32),
              np.full(2, w / 2.0, np.float32), np.full(2, h / 2.0, np.float32), R, t)
    return camera_array_from_numpy(*fields), jax_make_rig(*fields)


def _apply_h(H, uv):
    p = np.concatenate([uv, np.ones((len(uv), 1))], axis=1) @ np.asarray(H, np.float64).T
    return p[:, :2] / p[:, 2:3]


def test_look_at_rotation_matches_reference():
    rng = np.random.default_rng(4)
    for eye, target in zip(rng.normal(0, 1, (8, 3)), rng.normal(0, 1, (8, 3)) + [0, 0, 3]):
        np.testing.assert_array_equal(look_at_rotation(eye, target).numpy(),
                                      np.asarray(jax_look_at(eye, target)))


def test_rectify_pair_matches_reference_and_aligns_rows():
    cams, jcams = _verged_pair()
    rect, want = rectify_pair(cams, 0, 1), jrect.rectify_pair(jcams, 0, 1)
    for name in ("H_left", "H_right", "K_new", "R_new", "baseline"):
        a, b = getattr(rect, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-6 * np.abs(b).max())
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-0.4, 0.4, 40), rng.uniform(-0.3, 0.3, 40),
                    rng.uniform(1.5, 3.0, 40)], axis=-1).astype(np.float32)
    uv_l = cams[0].project(_t(pts))[0].numpy()
    uv_r = cams[1].project(_t(pts))[0].numpy()
    assert np.abs(uv_l[:, 1] - uv_r[:, 1]).max() > 0.5  # verged: rows differ before
    rl = _apply_h(np.linalg.inv(rect.H_left.numpy()), uv_l)
    rr = _apply_h(np.linalg.inv(rect.H_right.numpy()), uv_r)
    assert np.abs(rl[:, 1] - rr[:, 1]).max() < 1e-2
    disp = rl[:, 0] - rr[:, 0]
    assert (disp > 0).all()
    depth = rectified_disparity_to_depth(_t(disp.astype(np.float32)), rect).numpy()
    c_l = cams.centers[0].numpy()
    np.testing.assert_allclose(depth, (pts - c_l) @ rect.R_new.numpy()[2], rtol=1e-3)
    assert rectified_disparity_to_depth(_t([0.0, -1.0]), rect, invalid_fill=-7.0).tolist() == [-7.0, -7.0]


def test_rectify_pair_is_near_identity_for_a_rectified_rig():
    cams = reference_rig(rows=1, cols=2, spacing=0.1, resolution=(100, 140))
    rect = rectify_pair(cams, 0, 1)
    uv = np.random.default_rng(2).uniform(10, 90, size=(20, 2)).astype(np.float32)
    np.testing.assert_allclose(_apply_h(np.linalg.inv(rect.H_left.numpy()), uv), uv, atol=1e-3)
    np.testing.assert_allclose(_apply_h(np.linalg.inv(rect.H_right.numpy()), uv), uv, atol=1e-3)


def test_rectified_sgm_end_to_end():
    """tests/test_rectify.py's verged render through the port: rectified
    images against the reference's warps, then two-view SGM and metric
    depth around the scene's z = 0.75-0.85."""
    h, w = 96, 128
    cams, jcams = _verged_pair(baseline=0.1, depth=0.8, res=(h, w), f=160.0)
    img_l, _ = render_view(cams, 0, (h, w), SceneSpec())
    img_r, _ = render_view(cams, 1, (h, w), SceneSpec())
    rect = rectify_pair(cams, 0, 1)
    lw, lv, rw, rv = rectify_images(_t(img_l), _t(img_r), rect)
    jl = jrect.rectify_images(jnp.asarray(img_l), jnp.asarray(img_r), jrect.rectify_pair(jcams, 0, 1))
    for got, want in ((lv, jl[1]), (rv, jl[3])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want, valid in ((lw, jl[0], lv), (rw, jl[2], rv)):
        ok = valid.numpy()
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=0, atol=7e-4)
    out = two_view_disparity(lw, rw, CostConfig(num_disparities=32, census_window=(5, 5)),
                             SGMConfig(num_paths=4))
    depth = rectified_disparity_to_depth(out.disparity, rect).numpy()
    sel = out.valid.numpy() & lv.numpy() & (depth > 0)
    sel[:12], sel[-12:], sel[:, :40], sel[:, -12:] = False, False, False, False
    assert sel.mean() > 0.1
    assert 0.7 < np.median(depth[sel]) < 0.9


# ---- ATE -----------------------------------------------------------------------------------

@pytest.mark.parametrize("align,align_scale", [(True, False), (True, True), (False, False)])
def test_ate_matches_reference(align, align_scale):
    rng = np.random.default_rng(9)
    gt = rng.normal(0, 0.1, (25, 3)).astype(np.float32)
    th = 0.3
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    est = (1.3 * gt @ Rz.T + [0.2, -0.1, 0.05] + rng.normal(0, 1e-3, gt.shape)).astype(np.float32)
    got = float(absolute_trajectory_error(_t(est), _t(gt), align=align, align_scale=align_scale))
    want = float(jax_ate(jnp.asarray(est), jnp.asarray(gt), align=align, align_scale=align_scale))
    assert abs(got - want) <= 7e-8, (got, want)
    if align_scale:
        assert got < 3e-3
