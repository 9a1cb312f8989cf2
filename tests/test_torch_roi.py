"""The port's ROI (roi/mask.py, roi/detect.py, roi/face.py and the use_roi
gate of array_depth_pipeline) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances: the masks are bit-exact. The Otsu ellipse's moments are float
sums in another order than XLA's: centre and axes within 1e-3 px, angle
within 1e-4 rad, `found` equal. The face detector's NCC scores within 1e-4,
its box within one pixel of the pyramid level it came from, `found` equal,
the fitted landmarks within 0.05 px and the face mask's IoU >= 0.99. The
resampling helper within 1e-5 of jax.image on [0, 1] images.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu.config import EngineConfig
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu.roi import detect as jd
from stereovisionarray_tpu.roi import face as jf
from stereovisionarray_tpu.roi import mask as jm
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.models import array_depth_pipeline
from stereovisionarray_tpu_torch.roi import detect as td
from stereovisionarray_tpu_torch.roi import face as tf
from stereovisionarray_tpu_torch.roi import mask as tm

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_roi import _render_head, _render_head_affine  # noqa: E402
from test_torch_array_pipeline import _reference_route  # noqa: E402

SHAPE = (180, 240)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs six workers
    on the machine's cores, and ops split over every core in each worker
    oversubscribe them (a pipeline call then ran a hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iou(a, b) -> float:
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("seed", range(4))
def test_ellipse_and_polygon_masks_are_bit_exact(seed):
    rng = np.random.default_rng(seed)
    center = rng.uniform([40, 30], [200, 150]).astype(np.float32)
    axes = rng.uniform(5, 80, 2).astype(np.float32)
    angle = np.float32(rng.uniform(-np.pi, np.pi))
    want = np.asarray(jm.ellipse_mask(SHAPE, jnp.asarray(center), jnp.asarray(axes),
                                      jnp.asarray(angle)))
    got = tm.ellipse_mask(SHAPE, torch.from_numpy(center), torch.from_numpy(axes),
                          torch.tensor(angle)).numpy()
    assert np.array_equal(got, want) and 0 < want.sum() < want.size
    # a convex polygon in either winding, and the landmark recipe
    phi = np.sort(rng.uniform(0, 2 * np.pi, 9)) * (1 if seed % 2 else -1)
    poly = (center + np.stack([np.cos(phi), np.sin(phi)], -1) * axes).astype(np.float32)
    want = np.asarray(jm.convex_polygon_mask(SHAPE, jnp.asarray(poly)))
    assert np.array_equal(tm.convex_polygon_mask(SHAPE, torch.from_numpy(poly)).numpy(), want)
    lm = (center + rng.normal(0, 20, (68, 2))).astype(np.float32)
    assert np.array_equal(tm.face_mask_from_landmarks(SHAPE, torch.from_numpy(lm)).numpy(),
                          np.asarray(jm.face_mask_from_landmarks(SHAPE, jnp.asarray(lm))))
    got = tm.face_ellipse_from_landmarks(torch.from_numpy(lm))
    want = jm.face_ellipse_from_landmarks(jnp.asarray(lm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _blob_scene(seed):
    rng = np.random.default_rng(seed)
    vv, uu = np.mgrid[0:SHAPE[0], 0:SHAPE[1]].astype(np.float32)
    img = rng.uniform(0, 30, SHAPE).astype(np.float32)
    cu, cv, a, b = rng.uniform([60, 50, 15, 20], [180, 130, 50, 60])
    img[((uu - cu) / a) ** 2 + ((vv - cv) / b) ** 2 <= 1.0] += 150.0
    return img


@pytest.mark.parametrize("scene,invert", [("bright_head", False), ("dark_head", False),
                                          ("dark_head", True), ("blob0", False),
                                          ("blob1", False), ("speck", False)])
def test_detect_face_ellipse_matches_reference(scene, invert):
    if scene.endswith("head"):
        img = _render_head(bright_bg=scene == "bright_head", rng=np.random.default_rng(3))[0]
    elif scene == "speck":  # nothing to find: found must be False on both sides
        img = np.zeros(SHAPE, np.float32)
        img[50:52, 60:62] = 255.0
    else:
        img = _blob_scene(int(scene[-1]))
    want = jd.detect_face_ellipse(jnp.asarray(img), invert=invert)
    got = td.detect_face_ellipse(torch.from_numpy(img), invert=invert)
    assert bool(got.found) == bool(want.found)
    if not bool(want.found):  # arbitrary moments: the gate ignores them
        assert scene == "speck"
        return
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), atol=1e-3)
    np.testing.assert_allclose(got.axes.numpy(), np.asarray(want.axes), atol=1e-3)
    np.testing.assert_allclose(float(got.angle), float(want.angle), atol=1e-4)


# the record's head scenes (both background polarities) and the narrow, wide
# and tilted heads of tests/test_roi.py:325-329
HEADS = ([(_render_head, case) for case in torch_records.FACE_CASES]
         + [(_render_head_affine, case) for case in (
             dict(aspect=1.65), dict(aspect=1.05), dict(tilt=0.18), dict(aspect=1.6, tilt=-0.15))])


@pytest.mark.parametrize("scene", range(len(HEADS)))
def test_detect_fit_and_mask_match_reference(scene):
    render, case = HEADS[scene]
    img = render(rng=np.random.default_rng(scene), **case)[0]
    want = jf.detect_face(jnp.asarray(img))
    got = tf.detect_face(torch.from_numpy(img))
    assert bool(got.found) == bool(want.found) and bool(got.found)
    assert abs(float(got.score) - float(want.score)) <= 1e-4
    # one pixel of the level the box came from: its width / 44 image px
    assert np.abs(got.box.numpy() - np.asarray(want.box)).max() <= float(want.box[2]) / 44
    lm_want = np.asarray(jf.fit_landmarks(jnp.asarray(img), want))
    lm_got = tf.fit_landmarks(torch.from_numpy(img), got).numpy()
    np.testing.assert_allclose(lm_got, lm_want, atol=0.05)
    m_want = np.asarray(jf.face_mask(jnp.asarray(img)))
    m_got = tf.face_mask(torch.from_numpy(img)).numpy()
    assert _iou(m_got, m_want) >= 0.99


@pytest.mark.parametrize("threshold", [0.3, 0.99])
def test_face_mask_falls_back_to_the_ellipse(threshold):
    """No face above the threshold: the Otsu ellipse (both sides), and the
    featureless-blob case of tests/test_roi.py."""
    img = _blob_scene(2)
    m_want = np.asarray(jf.face_mask(jnp.asarray(img), threshold=threshold))
    m_got = tf.face_mask(torch.from_numpy(img), threshold=threshold).numpy()
    assert _iou(m_got, m_want) >= 0.99


@pytest.mark.parametrize("shape", [(144, 192), (115, 154), (92, 123), (56, 44), (300, 400)])
def test_resample_matches_jax_resize(shape):
    x = np.random.default_rng(1).uniform(0, 1, SHAPE).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "linear"))
    np.testing.assert_allclose(tf.resample_linear(torch.from_numpy(x), shape).numpy(), want,
                               atol=1e-5)


@pytest.mark.parametrize("scale,translation", [((1.7, 1.3), (-40.3, -70.2)),
                                               ((0.6, 0.8), (10.5, -3.25)),
                                               ((2.0, 2.0), (0.5, 0.5))])
def test_resample_matches_scale_and_translate(scale, translation):
    x = np.random.default_rng(2).uniform(0, 1, SHAPE).astype(np.float32)
    sc, tr = np.float32(scale), np.float32(translation)
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(x), (168, 132), (0, 1), jnp.asarray(sc), jnp.asarray(tr), "linear"))
    got = tf.resample_linear(torch.from_numpy(x), (168, 132),
                             scale=tuple(torch.tensor(v) for v in sc),
                             translation=tuple(torch.tensor(v) for v in tr))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_render_head_copy_equals_the_test_renderer():
    for case in torch_records.FACE_CASES:
        for seed in (0, 1):
            got = torch_records.render_head(rng=np.random.default_rng(seed), **case)
            want = _render_head(rng=np.random.default_rng(seed), **case)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("roi_mode", ["face", "otsu"])
def test_use_roi_gate_matches_reference(roi_mode):
    """array_depth_pipeline(use_roi=True) on the 3x3 rig: the gate's mask
    is the reference gate's (models/array_pipeline.py:170-180) and the
    outputs match the reference's kernel route given that mask."""
    h, w = 48, 64
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.num_planes": 16, "plane_sweep.topology": "CROSS",
                                     "refine.radius": 2, "refine.window": 7})
    cams = reference_rig(rows=3, cols=3, resolution=(h, w))
    images = np.round(render_camera_array(cams, (h, w))[0])
    got = array_depth_pipeline(torch.from_numpy(images), cams, cfg, use_roi=True,
                               roi_mode=roi_mode)
    ref = jnp.asarray(images[4])
    if roi_mode == "face":
        want_mask = np.asarray(jf.face_mask(ref))
    else:
        roi = jd.detect_face_ellipse(ref)
        want_mask = np.asarray(jm.ellipse_mask((h, w), roi.center, roi.axes, roi.angle)
                               | ~roi.found)
    mask = got.mask.numpy()
    assert _iou(mask, want_mask) >= 0.99 and 0 < mask.sum() < mask.size
    sweep, refined, _ = _reference_route(images, jax_rig(rows=3, cols=3, resolution=(h, w)),
                                         cfg, None, mask)
    assert not got.valid.numpy()[~mask].any()
    assert (got.valid.numpy() == np.asarray(sweep.valid)).mean() > 0.99
    both = got.valid.numpy() & np.asarray(sweep.valid)
    d = np.abs(got.refined_disparity.numpy() - np.asarray(refined))[both]
    assert (d <= 1e-3).mean() > 0.98
    explicit = array_depth_pipeline(torch.from_numpy(images), cams, cfg, mask=got.mask)
    assert torch.equal(explicit.refined_depth, got.refined_depth)
