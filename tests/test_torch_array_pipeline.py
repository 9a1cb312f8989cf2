"""The port's camera-array pipeline as a whole: the golden metrics of
``torch_records.ARRAY_GOLDEN`` on the CPU, a small rig against the reference's
kernel route (plane_sweep_depth with backend="pallas_interpret" and the
refine loop of models/array_pipeline.py:243-273), and the options it
refuses raising (use_roi: tests/test_torch_roi.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.datasets import SceneSpec as JaxScene
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu.datasets import render_camera_array as jax_render
from stereovisionarray_tpu.models import array_pipeline as jap
from stereovisionarray_tpu.models.plane_sweep import plane_sweep_depth as jax_sweep_depth
from stereovisionarray_tpu.models.two_view import depth_to_disparity as jax_z2d
from stereovisionarray_tpu.models.two_view import disparity_to_depth as jax_d2z
from stereovisionarray_tpu.ops.refine import multiview_refine as jax_refine
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.evaluation import array_depth_metrics
from stereovisionarray_tpu_torch.models import array_depth_pipeline

GOLDEN_CFG = {"camera.rows": 5, "camera.cols": 5, "plane_sweep.num_planes": 96,
              "plane_sweep.topology": "CROSS", "refine.radius": 3, "refine.window": 11}


def _reference_route(images, cams, cfg, ref_index, mask):
    """The reference's kernel route through the array pipeline's steps."""
    n = images.shape[0]
    ref_index, src = jap.reference_and_sources(cfg, n, ref_index)
    pad = jap._shift_warp_pad(cams, ref_index, src, cfg)
    imgs = jnp.asarray(images)
    sweep = jax_sweep_depth(imgs, cams, ref_index, src, cfg.plane_sweep, cfg.sgm,
                            mask=jnp.asarray(mask), shift_pad=pad, backend="pallas_interpret")
    baselines, b0 = jap.array_baselines(cams, ref_index, src)
    f_px = float(np.asarray(cams.fx)[ref_index])
    rc = cfg.refine
    ceiling = f_px * b0 / cfg.plane_sweep.z_near + (abs(rc.radius * rc.step)
                                                    + 0.5 * abs(rc.step)) * max(rc.iterations, 1)
    refined = jax_z2d(sweep.depth, b0, f_px)
    for _ in range(rc.iterations):
        refined = jax_refine(imgs[ref_index], imgs[jnp.asarray(src)], baselines, refined,
                             mask=jnp.asarray(mask) & sweep.valid, radius=rc.radius, step=rc.step,
                             window=rc.window, subpixel=rc.subpixel,
                             max_disparity=ceiling).disparity
    return sweep, refined, jnp.where(sweep.valid, jax_d2z(refined, b0, f_px), 0.0)


def test_array_golden_on_cpu():
    """The make_array_eval setup with integer images reaches ARRAY_GOLDEN."""
    cfg = EngineConfig().override(**GOLDEN_CFG)
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(135, 180))
    images, depths = render_camera_array(cams, (135, 180))
    out = array_depth_pipeline(torch.from_numpy(np.round(images)), cams, cfg, ref_index=12)
    got = array_depth_metrics(out.depth, out.refined_depth, out.valid, depths[12])
    for metric, tol in torch_records.ARRAY_GOLDEN_TOL.items():
        assert abs(got[metric] - torch_records.ARRAY_GOLDEN[metric]) <= tol, (metric, got)
    assert got["density"] == torch_records.ARRAY_GOLDEN["density"]


@pytest.mark.slow
def test_array_golden_reference_recompute():
    """Recomputes ARRAY_GOLDEN with JAX (about 20 s on a CPU)."""
    cfg = EngineConfig().override(**GOLDEN_CFG)
    cams = jax_rig(rows=5, cols=5, spacing=0.05, resolution=(135, 180))
    images, depths = jax_render(cams, (135, 180), JaxScene())
    sweep, _, refined_depth = _reference_route(np.round(images), cams, cfg, 12,
                                               np.ones((135, 180), bool))
    got = array_depth_metrics(np.asarray(sweep.depth), np.asarray(refined_depth),
                              np.asarray(sweep.valid), depths[12])
    assert got == torch_records.ARRAY_GOLDEN


def test_small_rig_matches_reference_route():
    h, w = 48, 64
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.num_planes": 16, "plane_sweep.topology": "CROSS",
                                     "refine.radius": 2, "refine.window": 7})
    cams = reference_rig(rows=3, cols=3, resolution=(h, w))
    images = np.round(render_camera_array(cams, (h, w))[0])
    mask = np.ones((h, w), bool)
    mask[:, :3] = False
    got = array_depth_pipeline(torch.from_numpy(images), cams, cfg, mask=torch.from_numpy(mask))
    sweep, refined, refined_depth = _reference_route(images, jax_rig(rows=3, cols=3,
                                                                     resolution=(h, w)),
                                                     cfg, None, mask)
    assert torch.equal(got.mask, torch.from_numpy(mask)) and not got.valid[:, :3].any()
    assert (got.valid.numpy() == np.asarray(sweep.valid)).mean() > 0.99
    assert (got.sweep.plane.numpy() == np.asarray(sweep.plane)).mean() > 0.99
    both = got.valid.numpy() & np.asarray(sweep.valid)
    d = np.abs(got.refined_disparity.numpy() - np.asarray(refined))[both]
    assert (d <= 1e-3).mean() > 0.98
    rel = np.abs(got.refined_depth.numpy() - np.asarray(refined_depth))[both] / np.asarray(
        refined_depth)[both]
    assert np.median(rel) < 1e-6
    plain = array_depth_pipeline(torch.from_numpy(images), cams, cfg, mask=torch.from_numpy(mask),
                                 backend="torch")
    for f in ("depth", "refined_depth", "disparity", "refined_disparity", "valid"):
        assert torch.equal(getattr(plain, f), getattr(got, f)), f


@pytest.mark.parametrize("option,exc,match", [
    (dict(backend="cuda"), ValueError, "CUDA tensor"),
])
def test_unported_options_raise(option, exc, match):
    cams = reference_rig(rows=3, cols=3, resolution=(16, 20))
    images = torch.from_numpy(render_camera_array(cams, (16, 20))[0])
    kw = {"cfg": EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3}), **option}
    with pytest.raises(exc, match=match):
        array_depth_pipeline(images, cams, **kw)


def test_cascade_that_fits_one_window_runs_flat():
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.cascade": True, "plane_sweep.num_planes": 8,
                                     "refine.radius": 1, "refine.window": 5})
    cams = reference_rig(rows=3, cols=3, resolution=(16, 20))
    images = torch.from_numpy(render_camera_array(cams, (16, 20))[0])
    out = array_depth_pipeline(images, cams, cfg)
    flat = array_depth_pipeline(images, cams, cfg.override(**{"plane_sweep.cascade": False}))
    assert torch.equal(out.refined_depth, flat.refined_depth)
    assert out.refined_depth.shape == (16, 20) and torch.isfinite(out.refined_depth).all()
