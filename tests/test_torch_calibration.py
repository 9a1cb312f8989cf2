"""The port's array calibration (models/calibration.py) against the JAX
package on the CPU, at tests/test_sfm.py's 3x3 @ 180x240 setups: a clean
render from a 1 cm perturbed guess, and a k1 = -0.4 lens from a 5 mm guess
with the distortion solve on. Each JAX reference is computed once.

Integer outputs are exact: the track table's validity, the observation and
track counts. Float tolerances, each about 3x the largest gap measured on
the CPU (the sums of LK, the distortion solve and the BA follow PyTorch's
order): track positions 1e-4 px (gap 2.7e-5); (k1, k2) from the same tracks
2e-5 (gap 5.9e-6); calibrated camera centres 1e-6 m (gap 3.7e-7) and the
ATE 1.2e-7 m (gap 3.6e-8) clean; with the lens centres 2e-6 m (gap 6e-7),
ATE 4e-8 m (gap 1.1e-8), k1 4e-6 and k2 1.5e-5 (gaps 1.1e-6, 4e-6); the
inlier reprojection error 1e-4 relative clean (gap 3.2e-5), 6e-4 with the
lens (gap 2.1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig as JaxEngineConfig
from stereovisionarray_tpu.config import SfMConfig
from stereovisionarray_tpu.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu.geometry.camera import make_camera_array
from stereovisionarray_tpu.geometry.distortion import Distortion as JaxDistortion
from stereovisionarray_tpu.geometry.distortion import distort_image as jax_distort_image
from stereovisionarray_tpu.models import calibration as jcal
from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.evaluation import absolute_trajectory_error
from stereovisionarray_tpu_torch.geometry import camera_array_from_numpy
from stereovisionarray_tpu_torch.models import calibration as tcal

RES = (180, 240)
CFG = SfMConfig(max_features=512, ba_iterations=30, ba_damping=1e-3)


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


def _ate(centers, rig):
    return float(absolute_trajectory_error(centers, _t(rig.centers), align_scale=True))


@pytest.fixture(scope="module")
def port_cfg():
    return EngineConfig.from_dict(JaxEngineConfig(sfm=CFG).to_dict()).sfm


def _setup(lens, rms, seed):
    """The 3x3 rig, its images (through `lens` when given) and a guess with
    `rms` metres of translation noise on every camera but the first."""
    rig = reference_rig(rows=3, cols=3, spacing=0.05, origin=(-0.05, -0.05), resolution=RES)
    imgs = jnp.asarray(render_camera_array(rig, RES)[0])
    if lens is not None:
        imgs = jnp.stack([jax_distort_image(imgs[i], rig[i], lens)[0] for i in range(len(rig))])
    t_bad = np.asarray(rig.t).copy()
    t_bad[1:] += np.random.default_rng(seed).normal(0, rms, t_bad[1:].shape).astype(np.float32)
    init = make_camera_array(rig.fx, rig.fy, rig.cx, rig.cy, np.asarray(rig.R), t_bad)
    return rig, np.asarray(imgs), init


@pytest.fixture(scope="module")
def clean():
    rig, imgs, init = _setup(None, 0.01, 0)
    return rig, imgs, init, jcal.calibrate_array(jnp.asarray(imgs), init, 4, CFG, rounds=2)


@pytest.fixture(scope="module")
def lensed():
    rig, imgs, init = _setup(JaxDistortion(k1=-0.4, k2=0.03), 0.005, 11)
    out = jcal.calibrate_array(jnp.asarray(imgs), init, 4, CFG, rounds=2,
                               estimate_distortion=True)
    return rig, imgs, init, out


def test_build_tracks_matches_reference(lensed, port_cfg):
    _, imgs, _, _ = lensed
    uv_j, ok_j = (np.asarray(a) for a in jcal.build_tracks(jnp.asarray(imgs), 4, CFG))
    uv_t, ok_t = tcal.build_tracks(_t(imgs), 4, port_cfg)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_allclose(uv_t.numpy()[ok_j], uv_j[ok_j], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(uv_t[4].numpy(), uv_j[4])  # the reference's own corners
    # (k1, k2) from the JAX tracks on both sides
    k_j = jcal._radial_from_vertical_parallax(jnp.asarray(uv_j), jnp.asarray(ok_j), lensed[2])
    k_t = tcal._radial_from_vertical_parallax(_t(uv_j), _t(ok_j), _port_rig(lensed[2]))
    np.testing.assert_allclose([float(k) for k in k_t], [float(k) for k in k_j], rtol=0, atol=2e-5)


def test_calibrate_array_recovers_a_clean_rig(clean, port_cfg):
    """tests/test_sfm.py's bounds through the port: ATE < 1.5 mm and below a
    quarter of the guess's; the counts equal the reference's."""
    rig, imgs, init, want = clean
    got = tcal.calibrate_array(_t(imgs), _port_rig(init), 4, port_cfg, rounds=2)
    ate0, ate1 = _ate(_t(init.centers), rig), _ate(got.cameras.centers, rig)
    assert ate1 < 0.0015 and ate1 < ate0 / 4, (ate0, ate1)
    assert int(got.num_obs) == int(want.num_obs) > 500
    np.testing.assert_array_equal(got.point_valid.numpy(), np.asarray(want.point_valid))
    assert abs(ate1 - _ate(_t(want.cameras.centers), rig)) < 1.2e-7
    np.testing.assert_allclose(got.cameras.centers.numpy(), np.asarray(want.cameras.centers),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.inlier_reproj), float(want.inlier_reproj), rtol=1e-4)
    assert got.distortion is None
    # the result carries its host copy: the array pipeline never reads it back
    host = got.cameras.host_fields
    assert host is not None
    for name in ("fx", "fy", "cx", "cy", "R", "t"):
        np.testing.assert_array_equal(getattr(host, name), getattr(got.cameras, name).numpy())


def test_calibrate_array_estimates_a_strong_lens(lensed, port_cfg):
    """k1 = -0.4: k1 within 0.06, ATE below 1 mm (tests/test_sfm.py), and the
    port within the stated gaps of the reference."""
    rig, imgs, init, want = lensed
    got = tcal.calibrate_array(_t(imgs), _port_rig(init), 4, port_cfg, rounds=2,
                               estimate_distortion=True)
    k1, k2 = (float(k) for k in got.distortion)
    assert abs(k1 + 0.4) < 0.06, (k1, k2)
    ate = _ate(got.cameras.centers, rig)
    assert ate < 0.001, ate
    assert int(got.num_obs) == int(want.num_obs)
    assert abs(k1 - float(want.distortion[0])) < 4e-6
    assert abs(k2 - float(want.distortion[1])) < 1.5e-5
    assert abs(ate - _ate(_t(want.cameras.centers), rig)) < 4e-8
    np.testing.assert_allclose(got.cameras.centers.numpy(), np.asarray(want.cameras.centers),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(got.inlier_reproj), float(want.inlier_reproj), rtol=6e-4)


@pytest.mark.slow
def test_reference_scale_record():
    """EVAL_SFM_r05.json's reference-scale row (scripts/make_sfm_eval_r05.py:
    62-76) and the calibrated depth of path (b) through the port on the CPU,
    against torch_records' records and their bounds: the 5x5 rig at 270x360, a
    k1 = -0.2, k2 = 0.03 lens, a 1 cm guess from default_rng(1)."""
    import torch_records

    got = torch_records.reference_scale_calibration(torch, "cpu")
    print("SFM_RECORD", got["calibration"], "CALIBRATED_DEPTH", got["depth"])
    assert not torch_records.record_misses(got["calibration"], torch_records.SFM_RECORD,
                                        torch_records.SFM_RECORD_TOL)
    assert not torch_records.record_misses(got["depth"], torch_records.CALIBRATED_DEPTH,
                                        torch_records.CALIBRATED_DEPTH_TOL)


def _reference_scale_jax():
    """scripts/make_sfm_eval_r05.py:62-76 with the JAX package: (rig, lensed
    images, guess, calibration)."""
    from stereovisionarray_tpu.datasets.synthetic import reference_rig as jrig
    from stereovisionarray_tpu.datasets.synthetic import render_camera_array as jrender

    res = (270, 360)
    rig = jrig(rows=5, cols=5, spacing=0.05, resolution=res)
    imgs, depths = jrender(rig, res)
    lens = JaxDistortion(k1=-0.2, k2=0.03)
    dimgs = jnp.stack([jax_distort_image(jnp.asarray(imgs[i]), rig[i], lens)[0]
                       for i in range(len(rig))])
    t_bad = np.asarray(rig.t).copy()
    t_bad[1:] += np.random.default_rng(1).normal(0, 0.01, t_bad[1:].shape).astype(np.float32)
    init = make_camera_array(rig.fx, rig.fy, rig.cx, rig.cy, np.asarray(rig.R), t_bad)
    out = jcal.calibrate_array(dimgs, init, 12, CFG, rounds=2, estimate_distortion=True)
    return rig, depths, dimgs, out


@pytest.mark.slow
def test_calibrated_depth_reference_recompute():
    """Recomputes torch_records.CALIBRATED_DEPTH with JAX on the CPU (a few
    minutes): the reference-scale calibration, the 25 lensed views
    undistorted with its (k1, k2) as cli.py:174-182 does, then the array
    pipeline's kernel route (tests/test_torch_array_pipeline.py's
    _reference_route: plane_sweep_depth with backend="pallas_interpret" and
    the refine loop) at bench_array.py's CROSS config on the calibrated rig."""
    import torch_records
    from stereovisionarray_tpu.config import EngineConfig as JaxEngine
    from stereovisionarray_tpu.geometry.distortion import undistort_image as jax_undistort
    from stereovisionarray_tpu_torch.evaluation import array_depth_metrics
    from test_torch_array_pipeline import _reference_route

    rig, depths, dimgs, cal = _reference_scale_jax()
    k1, k2 = (float(k) for k in cal.distortion)
    views = jnp.stack([jax_undistort(dimgs[i], cal.cameras[i], JaxDistortion(k1=k1, k2=k2))[0]
                       for i in range(len(rig))])
    cfg = JaxEngine().override(**torch_records.CALIBRATED_DEPTH_CFG)
    sweep, _, refined_depth = _reference_route(np.asarray(views), cal.cameras, cfg, 12,
                                               np.ones(views.shape[1:], bool))
    got = array_depth_metrics(np.asarray(sweep.depth), np.asarray(refined_depth),
                              np.asarray(sweep.valid), depths[12])
    print("CALIBRATED_DEPTH", got)
    assert got == torch_records.CALIBRATED_DEPTH
