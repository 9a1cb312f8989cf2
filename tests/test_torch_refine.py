"""The port's multi-view refinement against the JAX reference, for all three
warp paths (static candidate stack, warp-once, exact warp) with CROSS
(axis-aligned, integer candidate spacing) and to_center (diagonal, the
hat-blend branch) baselines: validity equal, refined disparity within 1e-3 px
on >= 99.5% of the pixels (the cumulative box sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.ops import refine as jref
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.models.array_pipeline import array_baselines, reference_and_sources
from stereovisionarray_tpu_torch.ops import refine

H, W = 40, 56


@pytest.fixture(scope="module")
def scene():
    cams = reference_rig(rows=5, cols=5, resolution=(H, W))
    images, depths = render_camera_array(cams, (H, W))
    return cams, images, depths


def _inputs(scene, topology):
    cams, images, depths = scene
    cfg = EngineConfig().override(**{"plane_sweep.topology": topology})
    ref, src = reference_and_sources(cfg, 25)
    baselines, b0 = array_baselines(cams, ref, src)
    f_px = float(cams.host().fx[ref])
    r = np.random.default_rng(7)
    disp = (f_px * b0 / depths[ref] + r.normal(0, 0.7, (H, W))).astype(np.float32)
    disp[:3, :5] = 0.0  # a non-positive candidate is no evidence
    mask = r.uniform(size=(H, W)) > 0.1
    return images[ref], images[list(src)], baselines, disp, mask, f_px * b0 / 0.55 + 6.0


@pytest.mark.parametrize("topology", ["CROSS", "to_center"])
@pytest.mark.parametrize("path", ["stack", "warp_once", "exact"])
def test_multiview_refine_matches_reference(scene, topology, path):
    ref, aux, baselines, disp, mask, ceiling = _inputs(scene, topology)
    kw = dict(radius=3, step=1.0, window=11, subpixel=True,
              exact_warp=path == "exact", max_disparity=ceiling if path == "stack" else None)
    got = refine.multiview_refine(torch.from_numpy(ref), torch.from_numpy(aux), baselines,
                                  torch.from_numpy(disp), mask=torch.from_numpy(mask), **kw)
    want = jref.multiview_refine(jnp.asarray(ref), jnp.asarray(aux), baselines, jnp.asarray(disp),
                                 mask=jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    d = np.abs(got.disparity.numpy() - np.asarray(want.disparity))
    assert (d <= 1e-3).mean() >= 0.995, (d <= 1e-3).mean()
    assert np.array_equal(got.disparity.numpy()[~mask], disp[~mask].clip(min=0))
    assert (np.abs(got.delta.numpy() - np.asarray(want.delta)) <= 1e-3).mean() >= 0.995


def test_candidate_stack_hat_branch_with_fractional_step(scene):
    """step 0.5 makes the CROSS candidate spacing fractional: the hat blend."""
    ref, aux, baselines, disp, mask, ceiling = _inputs(scene, "CROSS")
    kw = dict(radius=2, step=0.5, window=7, max_disparity=ceiling)
    got = refine.multiview_refine(torch.from_numpy(ref), torch.from_numpy(aux), baselines,
                                  torch.from_numpy(disp), **kw)
    want = jref.multiview_refine(jnp.asarray(ref), jnp.asarray(aux), baselines, jnp.asarray(disp),
                                 **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    d = np.abs(got.disparity.numpy() - np.asarray(want.disparity))
    assert (d <= 1e-3).mean() >= 0.995


@pytest.mark.parametrize("k", [1, 3, 11])
def test_box_filter2d_matches_reference(k):
    x = np.random.default_rng(k).uniform(0, 255, (2, 13, 17)).astype(np.float32)
    np.testing.assert_allclose(refine.box_filter2d(torch.from_numpy(x), k).numpy(),
                               np.asarray(jref.box_filter2d(jnp.asarray(x), k)),
                               rtol=1e-5, atol=1e-3)
