"""The port's array cascade (``models/cascade_sweep.py`` and its branch of
``models/array_pipeline.py``) against the JAX reference's kernel route
(``backend="pallas_interpret"``), and its helpers against the reference's.

Tolerances, and why:
 - the host parameters (band offsets, fine pad, the per-view shift steps and
   the fine shifts that K8 floors) are held bit-exact;
 - area downsample, edge pad and scaled intrinsics are exact;
 - the bilinear upsample is within 1e-6 relative (the reference's lerps may
   be contracted into fused multiply-adds);
 - the fine pass feeds bilinear pre-warped (non-integer) sources to the
   sweep, where the reference's kernel splits them into bf16 hi/lo parts
   inexactly and the port reads float32: census bits flip at near-ties, so
   the cascade is held statistically, with the bounds of
   tests/test_cascade_sweep.py:190-204 (equal validity, median plane
   difference < 0.1, within 1 plane on > 90% and within 2 on > 95% of the
   interior).
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu.config import EngineConfig, PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu.datasets import SceneSpec as JaxScene
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu.datasets import render_camera_array as jax_render
from stereovisionarray_tpu.geometry.epipolar import inverse_depth_samples as jax_depths
from stereovisionarray_tpu.models import array_pipeline as jap
from stereovisionarray_tpu.models import cascade_sweep as jcs
from stereovisionarray_tpu.models.plane_sweep import translation_shifts as jax_shifts
from stereovisionarray_tpu.models.two_view import depth_to_disparity as jax_z2d
from stereovisionarray_tpu.models.two_view import disparity_to_depth as jax_d2z
from stereovisionarray_tpu.ops.refine import multiview_refine as jax_refine
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.evaluation import cascade_depth_metrics
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.models import (
    array_depth_pipeline,
    cascade_plane_sweep_depth,
    cascade_static_params,
)
from stereovisionarray_tpu_torch.models import cascade_sweep as tcs
from stereovisionarray_tpu_torch.models.array_pipeline import _shift_warp_pad

RES = (96, 128)
REF = 4
SRC = tuple(i for i in range(9) if i != REF)
CFG = PlaneSweepConfig(num_planes=64, z_near=0.8, z_far=1.05, cost="census", patch=7,
                       fusion="topk_mean", topk=4)
SGM = SGMConfig(p1=1.0, p2=8.0, adaptive_p2=True, p2_min=2.0, lr_max_diff=0.0)
SHIFT_PAD = 14


def _rigs(res=RES, rows=3, cols=3, **kw):
    kw = {"spacing": 0.05, "origin": (-0.05, -0.05), **kw} if rows == 3 else {"spacing": 0.05, **kw}
    return (reference_rig(rows=rows, cols=cols, resolution=res, **kw),
            jax_rig(rows=rows, cols=cols, resolution=res, **kw))


def _inner(shape):
    m = np.zeros(shape, bool)
    m[8:-8, 8:-8] = True
    return m


@functools.lru_cache(maxsize=None)
def _runs(mode):
    cams, jcams = _rigs()
    images = render_camera_array(cams, RES)[0]
    bo, fp = cascade_static_params(cams, REF, SRC, CFG, 32)
    kw = dict(shift_pad=SHIFT_PAD, coarse_factor=2, fine_planes=32, band_step=8, band_offsets=bo,
              fine_shift_pad=fp, mode=mode)
    want = jcs.cascade_plane_sweep_depth(jnp.asarray(images), jcams, REF, SRC, CFG, SGM,
                                         backend="pallas_interpret", **kw)
    got = cascade_plane_sweep_depth(torch.from_numpy(images), cams, REF, SRC, CFG, SGM, **kw)
    return jax.tree_util.tree_map(np.asarray, tuple(want)), got


@pytest.mark.parametrize("rows,res,fine", [(3, RES, 32), (3, RES, 48), (5, (270, 360), 48)])
def test_static_params_equal_reference(rows, res, fine):
    cams, jcams = _rigs(res, rows, rows)
    ref, src, cfg = (REF, SRC, CFG) if rows == 3 else (12, (7, 11, 13, 17), PlaneSweepConfig())
    assert (cascade_static_params(cams, ref, src, cfg, fine)
            == jcs.cascade_static_params(jcams, ref, src, cfg, fine))


@pytest.mark.parametrize("rows,res,planes,fine", [(3, RES, 64, 32), (5, (270, 360), 128, 48),
                                                  (5, (135, 180), 97, 24)])
def test_fine_shifts_bit_equal_reference(rows, res, planes, fine):
    """The shift intercepts a, steps c and fine shifts c * j (which K8
    floors) as the reference's compiled arithmetic gives them
    (cascade_sweep.py:296-299,405-406), with the cameras traced as in its
    jitted cascade. They read only the end planes, whose depths are exact
    under any compilation of the inverse-depth linspace."""
    cams, jcams = _rigs(res, rows, rows)
    ref, src = (REF, SRC) if rows == 3 else (12, (7, 11, 13, 17))
    cfg = dataclasses.replace(CFG, num_planes=planes)

    @jax.jit
    def reference(cameras):
        depths = jax_depths(cfg.z_near, cfg.z_far, planes, dtype=jnp.float32)
        sh = jax_shifts(cameras, ref, list(src), depths)
        a = sh[:, 0, :]
        c = (sh[:, planes - 1, :] - a) / max(planes - 1, 1)
        return a, c, c[:, None, :] * jnp.arange(fine, dtype=jnp.float32)[None, :, None]

    _, a, c = tcs.linear_shift_params(cams, ref, src, cfg)
    fine_shifts = c[:, None, :] * np.arange(fine, dtype=np.float32)[None, :, None]
    for name, got, want in zip(("a", "c", "fine_shifts"), (a, c, fine_shifts), reference(jcams)):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_cascade_matches_reference_route(mode):
    want, got = _runs(mode)
    va, vb = want[3], got.valid.numpy()
    assert (va == vb).all()
    both = va & vb & _inner(va.shape)
    assert both.mean() > 0.5
    dk = np.abs(got.plane.numpy() - want[1])[both]
    assert np.median(dk) < 0.1
    assert (dk <= 1.0).mean() > 0.90
    assert (dk <= 2.0).mean() > 0.95
    np.testing.assert_array_equal(got.num_views.numpy()[both], want[4][both])


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_cascade_outputs_are_consistent(mode):
    _, got = _runs(mode)
    v = got.valid
    assert got.plane.shape == RES and got.num_views.dtype == torch.int32
    assert torch.isfinite(got.depth).all() and not got.depth[~v].any() and (got.depth[v] > 0).all()
    assert not got.confidence[~v].any() and (got.confidence[v] < 1).all()
    assert (got.num_views[v] >= 2).all() and got.plane.max() <= CFG.num_planes - 1 + 0.5


@pytest.mark.parametrize("s", [2, 4])
def test_coarse_helpers_match_reference(s):
    rng = np.random.default_rng(s)
    imgs = rng.uniform(0, 255, (3, 37, 50)).astype(np.float32)
    padded = jax.jit(lambda x: jcs._pad_to_multiple(x, s))(imgs)
    np.testing.assert_array_equal(tcs.pad_to_multiple(torch.from_numpy(imgs), s).numpy(),
                                  np.asarray(padded))
    want = np.asarray(jax.jit(lambda x: jcs._area_downsample(x, s))(padded))
    got = tcs.area_downsample(tcs.pad_to_multiple(torch.from_numpy(imgs), s), s).numpy()
    np.testing.assert_array_equal(got, want)
    k = rng.uniform(0, 60, (9, 13)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jcs._upsample_bilinear(x, s))(k))
    np.testing.assert_allclose(tcs.upsample_bilinear(torch.from_numpy(k), s).numpy(), want,
                               rtol=1e-6)


def test_scaled_cameras_match_reference():
    cams, jcams = _rigs()
    for s in (2, 4):
        got, want = tcs.scale_cameras(cams, s).host(), jax.jit(
            lambda c: jcs._scale_cameras(c, s))(jcams)
        for f in ("fx", "fy", "cx", "cy", "R", "t"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_array_pipeline_runs_the_cascade(mode):
    """array_depth_pipeline(plane_sweep.cascade) is cascade_plane_sweep_depth
    plus the refinement, and lands near the flat pipeline on the 3x3 rig
    (tests/test_cascade_sweep.py:260-290)."""
    cams, _ = _rigs()
    images, deps = render_camera_array(cams, RES)
    base = {"camera.rows": 3, "camera.cols": 3, "plane_sweep.num_planes": 64,
            "plane_sweep.z_near": 0.8, "plane_sweep.z_far": 1.05,
            "plane_sweep.topology": "CROSS", "refine.radius": 3, "refine.window": 11}
    flat_cfg = EngineConfig().override(**base)
    casc_cfg = flat_cfg.override(**{"plane_sweep.cascade": True, "plane_sweep.cascade_mode": mode,
                                    "plane_sweep.cascade_fine_planes": 32})
    imgs = torch.from_numpy(images)
    out = array_depth_pipeline(imgs, cams, casc_cfg, ref_index=4)
    ps = casc_cfg.plane_sweep
    src = jap.reference_and_sources(casc_cfg, 9, 4)[1]
    bo, _ = cascade_static_params(cams, 4, src, ps, 32)
    sweep = cascade_plane_sweep_depth(imgs, cams, 4, src, ps, casc_cfg.sgm,
                                      shift_pad=_shift_warp_pad(cams, 4, src, casc_cfg),
                                      fine_planes=32, band_offsets=bo, mode=mode)
    for f in ("plane", "cost", "valid", "num_views", "confidence"):
        assert torch.equal(getattr(out.sweep, f), getattr(sweep, f)), f
    meds = {}
    for name, o in (("flat", array_depth_pipeline(imgs, cams, flat_cfg, ref_index=4)),
                    ("cascade", out)):
        sel = o.valid.numpy() & _inner(RES)
        assert sel.sum() > 0.9 * _inner(RES).sum()
        meds[name] = np.median(np.abs(o.refined_depth.numpy()[sel] - deps[4][sel]) / deps[4][sel])
    assert meds["cascade"] < max(3.0 * meds["flat"], 0.01), meds


def test_array_pipeline_cascade_falls_back_when_range_fits_window():
    """plane_sweep.cascade with num_planes <= cascade_fine_planes runs the
    flat sweep (array_pipeline.py:183-189)."""
    cams, _ = _rigs((48, 64))
    imgs = torch.from_numpy(render_camera_array(cams, (48, 64))[0])
    base = {"camera.rows": 3, "camera.cols": 3, "plane_sweep.num_planes": 32,
            "plane_sweep.topology": "CROSS", "refine.iterations": 0}
    flat = array_depth_pipeline(imgs, cams, EngineConfig().override(**base), ref_index=4)
    casc = array_depth_pipeline(imgs, cams, EngineConfig().override(
        **{**base, "plane_sweep.cascade": True}), ref_index=4)
    assert torch.equal(flat.depth, casc.depth) and torch.equal(flat.valid, casc.valid)


def test_cascade_requires_a_translation_rig():
    cams, _ = _rigs((24, 32))
    imgs = torch.from_numpy(render_camera_array(cams, (24, 32))[0])
    c, s = np.cos(0.02), np.sin(0.02)
    R = cams.R.clone()
    R[0] = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=R.dtype) @ R[0]
    general = CameraArray(fx=cams.fx, fy=cams.fy, cx=cams.cx, cy=cams.cy, R=R, t=cams.t)
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.cascade": True, "plane_sweep.num_planes": 64})
    with pytest.raises(ValueError, match="translation-only rig"):
        array_depth_pipeline(imgs, general, cfg, ref_index=4)
    with pytest.raises(ValueError, match="translation"):
        cascade_plane_sweep_depth(imgs, cams, REF, SRC, CFG, SGM, shift_pad=0)


@pytest.mark.parametrize("planes,fine,step,mode", [(64, 12, 8, "smooth"), (24, 32, 8, "smooth"),
                                                   (64, 32, 8, "nearest")])
def test_rejects_bad_band_geometry(planes, fine, step, mode):
    cams, jcams = _rigs((24, 32))
    imgs = render_camera_array(cams, (24, 32))[0]
    cfg = dataclasses.replace(CFG, num_planes=planes)
    kw = dict(shift_pad=SHIFT_PAD, fine_planes=fine, band_step=step, mode=mode)
    with pytest.raises(ValueError) as want:
        jcs.cascade_plane_sweep_depth(jnp.asarray(imgs), jcams, REF, SRC, cfg, SGM, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        cascade_plane_sweep_depth(torch.from_numpy(imgs), cams, REF, SRC, cfg, SGM, **kw)


def test_array_cascade_golden_on_cpu():
    """The full-size array cascade on the CPU lands within CASCADE_GOLDEN_TOL
    of the reference's metrics."""
    got = torch_records.array_cascade_metrics(torch, torch.device("cpu"))
    want = torch_records.CASCADE_GOLDEN["array"]
    for m, tol in torch_records.CASCADE_GOLDEN_TOL["array"].items():
        assert abs(got[m] - want[m]) <= tol, (m, got)


@pytest.mark.slow
def test_array_cascade_golden_reference_recompute():
    """Recomputes CASCADE_GOLDEN["array"] with JAX at full size (25 views of
    270x360, 128 planes, CROSS; about 30 s on a CPU): the reference's
    cascade sweep on its kernel route and the refine loop of
    models/array_pipeline.py:243-273."""
    rows, cols, h, w, planes = torch_records.ARRAY_SHAPE
    cams = jax_rig(rows=rows, cols=cols, spacing=0.05, resolution=(h, w))
    images, depths = jax_render(cams, (h, w), JaxScene())
    cfg = EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                     "plane_sweep.num_planes": planes, **torch_records.ARRAY_CASCADE})
    ref, src = jap.reference_and_sources(cfg, rows * cols, None)
    ps = cfg.plane_sweep
    bo, _ = jcs.cascade_static_params(cams, ref, src, ps, ps.cascade_fine_planes)
    imgs = jnp.asarray(images)
    sweep = jcs.cascade_plane_sweep_depth(
        imgs, cams, ref, src, ps, cfg.sgm, mask=jnp.ones((h, w), bool),
        shift_pad=jap._shift_warp_pad(cams, ref, src, cfg), coarse_factor=ps.cascade_coarse_factor,
        fine_planes=ps.cascade_fine_planes, band_step=ps.cascade_band_step, band_offsets=bo,
        mode=ps.cascade_mode, backend="pallas_interpret")
    baselines, b0 = jap.array_baselines(cams, ref, src)
    f_px = float(np.asarray(cams.fx)[ref])
    rc = cfg.refine
    ceiling = f_px * b0 / ps.z_near + (abs(rc.radius * rc.step)
                                       + 0.5 * abs(rc.step)) * max(rc.iterations, 1)
    refined = jax_z2d(sweep.depth, b0, f_px)
    for _ in range(rc.iterations):
        refined = jax_refine(imgs[ref], imgs[jnp.asarray(src)], baselines, refined,
                             mask=sweep.valid, radius=rc.radius, step=rc.step, window=rc.window,
                             subpixel=rc.subpixel, max_disparity=ceiling).disparity
    depth = jnp.where(sweep.valid, jax_d2z(refined, b0, f_px), 0.0)
    got = cascade_depth_metrics(np.asarray(depth), np.asarray(sweep.valid), depths[ref])
    assert got == pytest.approx(torch_records.CASCADE_GOLDEN["array"], rel=0, abs=1e-7)
