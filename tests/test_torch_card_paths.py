"""The port's paths on the card, at the shapes they run at in use, each
output bit-exact to the same call with ``backend="torch"`` (the plain twins
on the same card), with the C entry points each launches; the goldens and
the records of the JAX package on the card; every CLI subcommand.

- two-view: the integer path at the bench shape (540x768, D=64, int8) and
  at the entry shape (256x384, D=64, int16), one extraction a frame with
  the LR check inside it and no standalone K5; the float32 route there, K7's
  strip route and K6 with the LR check in one launch;
- the array at the 5x5 rig's 270x360x128, CROSS and to_center: K8, K2/K3,
  K4 and the refinement's two entry points a pass, its pass held to the
  plain route; with ZNCC costs (K7, K6) and without SGM (K8, K6);
- the cascades: the two-view cascade at 540x768, 256 disparities (int8),
  on its large-range scene, and the array cascade at the CROSS shape, in
  smooth and band mode, the array pre-warp one 2-D K9 launch;
- every extraction and cost volume a path launches stages its rows in shared
  memory (never the generic form);
- the served loop (stream_depth_maps, the chunked loop with the temporal
  filter) over eight CROSS frame-sets from PNGs, against direct calls;
  use_roi in both modes, on a served set and on a head scene;
- SfM: calibrate_array at EVAL_SFM_r05.json's scale (path (a)), the
  calibrated rig's depth (path (b): the homography chain, no K8) and a
  verged 540x768 pair rectified (path (c));
- the goldens (int16, int8, float32, the array's and the cascades'), the
  face, temporal, fusion and SfM records, each against ``torch_records``;
- the CLI: every subcommand in-process, each artifact bit-exact to the
  port's functions called directly with backend="torch" on the images the
  CLI decoded, each printed key set ``CLI_KEYS``'; ``python -m`` in its own
  process; the fixture's `evaluate` against GOLDEN.

Needs a CUDA device and nvcc; without one every test skips. The GPU machine
has no JAX, so run these without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_card_paths.py -q
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_records as rec
from stereovisionarray_tpu_torch import cli, config
from stereovisionarray_tpu_torch.models import array_depth_pipeline, two_view_disparity
from stereovisionarray_tpu_torch.ops.extract_cuda import FORMS
from torch_launches import launched  # noqa: F401

pytestmark = pytest.mark.gpu

ROWS, COLS, AH, AW, AD = rec.ARRAY_SHAPE
REF = (ROWS // 2) * COLS + COLS // 2
FIELDS = ("depth", "refined_depth", "disparity", "refined_disparity", "valid")
SWEEP_FIELDS = ("depth", "plane", "cost", "valid", "num_views", "confidence")
TWO_VIEW_FIELDS = ("disparity", "valid", "cost", "confidence")
TWO_VIEW = {"svt_cost_volume", "svt_sgm_paths", "svt_extract_maps"}
ARRAY = {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps", "svt_refine_costs",
         "svt_refine_select"}
SGM = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True)
# the fixture's: adaptive P2, uniqueness 0.95, LR 1.5
FIXTURE_SGM = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True, uniqueness=0.95,
                               lr_max_diff=1.5)


@pytest.fixture(scope="module")
def card():
    """The card, with TF32 off for the module's products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _same(got, want, fields=None):
    """Each of `fields` of `got` and `want` (or the two tensors) equal bit
    for bit."""
    pairs = ([(f, getattr(got, f), getattr(want, f)) for f in fields] if fields
             else [("", got, want)])
    for name, a, b in pairs:
        if a is None and b is None:  # a map both routes leave out
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, (a.double() - b.double()).abs().max().item())


def _extractions(launched):
    """Whether each extraction launched ran the LR check inside it."""
    return [args[7] > 0 for args in launched.of("svt_extract_maps")]


def _staged(launched):
    """Every extraction and cost volume launched stages the row in shared
    memory (the extraction's tiled or split form, the cost volume's tiled
    form), never the generic form."""
    assert all(FORMS[args[8]] != "generic" for args in launched.of("svt_extract_maps")), \
        launched.args
    assert all(args[13] > 0 for args in launched.of("svt_cost_volume")), launched.args


def _array_config(planes=AD, **overrides):
    return config.EngineConfig().override(**{
        "camera.rows": ROWS, "camera.cols": COLS, "plane_sweep.num_planes": planes, **overrides})


@pytest.fixture(scope="module")
def rig(card):
    """The 5x5 reference rig at 270x360 and its rendered views on the card."""
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array

    cams = reference_rig(rows=ROWS, cols=COLS, spacing=0.05, resolution=(AH, AW))
    return cams, torch.from_numpy(render_camera_array(cams, (AH, AW))[0]).cuda()


# ---- two-view ---------------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["bench", "entry"])
@pytest.mark.parametrize("dtype", ["integer", "float32"])
def test_two_view_path(card, launched, run, dtype):
    """The integer path (int8 at the bench shape, int16 at the entry shape):
    K1, K2/K3, one extraction with the LR check inside it, no standalone K5.
    float32 costs: K1's float store, K7's strip route (never its generic
    form) and K6 with the LR check in one launch."""
    (h, w, D), offset = (rec.BENCH_SHAPE, 32) if run == "bench" else (rec.ENTRY_SHAPE, 16)
    if dtype == "float32":
        cost_dtype, sc = "float32", FIXTURE_SGM
        entries = {"svt_cost_volume", "svt_sgm_float_strips", "svt_extract_maps"}
    else:
        cost_dtype, sc, entries = "int8" if run == "bench" else "int16", SGM, TWO_VIEW
    cc = config.CostConfig(num_disparities=D, census_window=(7, 9), dtype=cost_dtype)
    pair = rec.stereo_pair(torch, h, w, seed=0, offset=offset)
    out = two_view_disparity(*pair, cc, sc)
    assert set(launched) == entries, launched
    assert _extractions(launched) == [True]
    _staged(launched)
    _same(out, two_view_disparity(*pair, cc, sc, backend="torch"), TWO_VIEW_FIELDS)
    assert bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
    assert tuple(out.disparity.shape) == (h, w)


# ---- the array ---------------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["CROSS", "to_center"])
def test_array_path(card, launched, rig, topology):
    """array_depth_pipeline at the array cells' shape: K8, K2/K3 over the
    planes, K4 and the refinement's pass (three launches: two entry
    points); then that pass alone against its plain route, every output."""
    from stereovisionarray_tpu_torch.models import array_baselines, reference_and_sources
    from stereovisionarray_tpu_torch.ops.refine import multiview_refine

    cams, images = rig
    cfg = _array_config(**{"plane_sweep.topology": topology})
    out = array_depth_pipeline(images, cams, cfg)
    assert set(launched) == ARRAY, launched
    assert (launched.count("svt_refine_costs"), launched.count("svt_refine_select")) == (1, 1)
    _staged(launched)
    plain = array_depth_pipeline(images, cams, cfg, backend="torch")
    _same(out, plain, FIELDS)
    _same(out.sweep, plain.sweep, SWEEP_FIELDS)
    assert bool(torch.isfinite(out.refined_depth).all() and torch.isfinite(out.depth).all())
    assert tuple(out.refined_depth.shape) == (AH, AW)

    # the pass at the pipeline's own disparities: 4 views whole-step at
    # CROSS, 24 views and the hat blend at to_center; radius 5, window 21
    ref, src = reference_and_sources(cfg, ROWS * COLS)
    bl, _ = array_baselines(cams, ref, src)
    rc = cfg.refine
    ceiling = float(out.disparity.max()) + 2 * abs(rc.radius * rc.step)
    aux = images[list(src)].to(torch.float32)
    call = lambda b: multiview_refine(  # noqa: E731
        images[ref].to(torch.float32), aux, bl, out.disparity, mask=out.mask & out.valid,
        radius=rc.radius, step=rc.step, window=rc.window, subpixel=rc.subpixel,
        max_disparity=ceiling, backend=b)
    got = call("cuda")
    _same(got, call("torch"), got._fields)


@pytest.mark.parametrize("run", ["array_zncc", "plane_sweep_no_sgm"])
def test_float_array_path(card, launched, rig, run):
    """The array's ZNCC path (the plain box-filter costs, then K7's strip
    route, K6 and the refinement) and the raw WTA plane sweep (K8, then K6)
    at the CROSS shape."""
    from stereovisionarray_tpu_torch.models.array_pipeline import (
        _shift_warp_pad,
        reference_and_sources,
    )
    from stereovisionarray_tpu_torch.models.plane_sweep import plane_sweep_depth

    cams, images = rig
    cross = _array_config(**{"plane_sweep.topology": "CROSS"})
    if run == "array_zncc":
        cfg = _array_config(**{"plane_sweep.topology": "CROSS", "plane_sweep.cost": "zncc"})
        call = lambda b: array_depth_pipeline(images, cams, cfg, backend=b)  # noqa: E731
        entries = {"svt_sgm_float_strips", "svt_extract_maps", "svt_refine_costs",
                   "svt_refine_select"}
    else:
        ref, src = reference_and_sources(cross, ROWS * COLS)
        pad = _shift_warp_pad(cams, ref, src, cross)
        call = lambda b: plane_sweep_depth(images, cams, ref, src, cross.plane_sweep, None,  # noqa: E731
                                           backend=b, shift_pad=pad)
        entries = {"svt_plane_sweep", "svt_extract_maps"}
    out = call("auto")
    assert set(launched) == entries, launched
    _staged(launched)
    plain = call("torch")
    if run == "array_zncc":
        _same(out, plain, FIELDS)
        _same(out.sweep, plain.sweep, SWEEP_FIELDS)
    else:
        _same(out, plain, SWEEP_FIELDS)
    assert bool(torch.isfinite(out.depth).all())


# ---- the cascades ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_two_view_cascade(card, launched, mode):
    """cascade_two_view_disparity at 540x768, 256 disparities (int8) on its
    large-range scene: K1-K4 on both passes, each extraction with the LR
    check inside it; K9 warps the smooth mode's residual (band mode warps
    and decodes by gathers)."""
    left, right, _, _ = rec.two_view_cascade_scene(torch, "cuda")
    out = rec.two_view_cascade_run(left, right, mode)
    assert TWO_VIEW <= set(launched) and "svt_lr_gather" not in launched, launched
    assert ("svt_hat_sample" in launched) or mode == "band"
    ext = _extractions(launched)
    assert len(ext) == 2 and any(ext), ext  # coarse and fine, the LR check inside
    _staged(launched)
    plain = rec.two_view_cascade_run(left, right, mode, backend="torch")
    _same(out, plain, (*TWO_VIEW_FIELDS, "coarse_disparity", "band_offset"))
    assert bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
    assert tuple(out.disparity.shape) == rec.CASCADE_SHAPE[:2]


@pytest.mark.parametrize("mode", ["smooth", "band"])
def test_array_cascade(card, launched, rig, mode):
    """array_depth_pipeline with plane_sweep.cascade at the CROSS shape: K8,
    K2/K3, K4 and the refinement; the smooth mode's pre-warp is one 2-D K9
    launch and no 1-D one, band mode's none."""
    cams, images = rig
    cfg = _array_config(**rec.ARRAY_CASCADE, **{"plane_sweep.cascade_mode": mode})
    out = array_depth_pipeline(images, cams, cfg)
    assert ARRAY <= set(launched), launched
    assert launched.count("svt_hat_sample") == 0
    assert launched.count("svt_hat_sample_2d") == (mode == "smooth")
    _staged(launched)
    plain = array_depth_pipeline(images, cams, cfg, backend="torch")
    _same(out, plain, FIELDS)
    _same(out.sweep, plain.sweep, SWEEP_FIELDS)
    assert bool(torch.isfinite(out.refined_depth).all() and torch.isfinite(out.depth).all())
    assert tuple(out.refined_depth.shape) == (AH, AW)


# ---- goldens -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_scene(card):
    """data/eval_scene on the card: (left, right, gt, matchable, ndisp)."""
    from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair

    pair = load_middlebury_pair(str(rec.REPO / "data" / "eval_scene"))
    gt = torch.from_numpy(pair.gt_disparity).cuda()
    x = torch.arange(gt.shape[1], device=gt.device)[None, :]
    matchable = torch.from_numpy(pair.valid_gt).cuda() & (x >= torch.ceil(gt))
    return (torch.from_numpy(pair.left).cuda(), torch.from_numpy(pair.right).cuda(), gt,
            matchable, pair.ndisp)


@pytest.mark.parametrize("dtype", ["int16", "int8", "float32"])
def test_golden(card, eval_scene, dtype):
    """The fixture's bad-2.0, EPE and density against the reference's: the
    integer route's GOLDEN and the float32 route's FLOAT_GOLDEN, to 1e-6."""
    from stereovisionarray_tpu_torch.evaluation import bad_pixel_ratio, end_point_error

    left, right, gt, matchable, ndisp = eval_scene
    cc = config.CostConfig(num_disparities=ndisp, census_window=(7, 9), dtype=dtype)
    out = two_view_disparity(left, right, cc, FIXTURE_SGM)
    em = matchable & out.valid
    got = {"bad_2.0": bad_pixel_ratio(out.disparity, gt, 2.0, mask=em).item(),
           "epe": end_point_error(out.disparity, gt, mask=em).item(),
           "density": ((out.valid & matchable).float().mean() / matchable.float().mean()).item()}
    want, tol = ((rec.FLOAT_GOLDEN, rec.FLOAT_GOLDEN_TOL) if dtype == "float32"
                 else (rec.GOLDEN[dtype], rec.GOLDEN_TOL))
    assert {m: got[m] - want[m] for m in want if abs(got[m] - want[m]) > tol} == {}, got


def test_array_golden(card):
    """scripts/make_array_eval.py's setup with integer images (5x5 at
    135x180, 96 planes, CROSS, refine radius 3, window 11) against
    ARRAY_GOLDEN."""
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.evaluation import array_depth_metrics

    cams = reference_rig(rows=ROWS, cols=COLS, spacing=0.05, resolution=(135, 180))
    images, depths = render_camera_array(cams, (135, 180))
    cfg = _array_config(96, **{"plane_sweep.topology": "CROSS", "refine.radius": 3,
                               "refine.window": 11})
    out = array_depth_pipeline(torch.round(torch.from_numpy(images).cuda()), cams, cfg,
                               ref_index=REF)
    got = array_depth_metrics(out.depth, out.refined_depth, out.valid, depths[REF])
    assert rec.record_misses(got, rec.ARRAY_GOLDEN, rec.ARRAY_GOLDEN_TOL) == {}, got


@pytest.mark.parametrize("path", ["two_view", "array"])
def test_cascade_golden(card, path):
    """Both cascades' accuracy on their scenes against CASCADE_GOLDEN."""
    metrics = rec.two_view_cascade_metrics if path == "two_view" else rec.array_cascade_metrics
    got = metrics(torch, "cuda")
    assert rec.record_misses(got, rec.CASCADE_GOLDEN[path], rec.CASCADE_GOLDEN_TOL[path]) == {}, \
        got


# ---- the served capture path ------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(card, tmp_path_factory):
    """SERVED_SETS CROSS frame-sets as PNGs: (rig on the card, config, set
    directories, temporal settings)."""
    return rec.served_scene(torch, tmp_path_factory.mktemp("served"))


def test_served_path(card, launched, served):
    """stream_depth_maps (depth 2) and stream_depth_maps_chunked (chunks of
    4, the temporal filter) over the decoded sets, in order, every output
    equal to direct pipeline calls and the port's filter over them; set 0
    equal to backend="torch"; K8, K2/K3 and K4 launch."""
    from stereovisionarray_tpu_torch.models import (
        frame_sets_from_dirs,
        stream_depth_maps,
        stream_depth_maps_chunked,
        temporal_init,
        temporal_update,
    )
    from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth

    cams, cfg, dirs, params = served
    stacks = list(frame_sets_from_dirs(dirs))
    got = list(stream_depth_maps(iter(stacks), cams, cfg, depth=2, device="cuda"))
    chunked = list(stream_depth_maps_chunked(iter(stacks), cams, cfg, depth=2, chunk=4,
                                             temporal=params, device="cuda"))
    assert {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps"} <= set(launched)
    _staged(launched)
    assert [r.index for r in got] == [r.index for r in chunked] == list(range(len(stacks)))
    direct = [array_depth_pipeline(torch.from_numpy(st).cuda(), cams, cfg) for st in stacks]
    for results in (got, chunked):
        for r, want in zip(results, direct):
            _same(r.output, want, (*FIELDS, "mask"))
            _same(r.output.sweep, want.sweep, SWEEP_FIELDS)
    state = temporal_init(tuple(direct[0].refined_disparity.shape), "cuda")
    for r, out in zip(chunked, direct):
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence, max_diff=params.max_diff,
                                      max_weight=params.max_weight,
                                      max_hole_age=params.max_hole_age)
        _same(r.temporal, tout, ("disparity", "valid", "stability", "coasted"))
        _same(r.depth, torch.where(tout.valid, disparity_to_depth(
            tout.disparity, params.baseline, params.focal_px), 0.0))
    plain = array_depth_pipeline(torch.from_numpy(stacks[0]).cuda(), cams, cfg, backend="torch")
    _same(direct[0], plain, FIELDS)
    assert all(bool(torch.isfinite(r.output.refined_depth).all()) for r in got)


@pytest.mark.parametrize("mode", ["face", "otsu"])
@pytest.mark.parametrize("scene", ["served_set", "head_reference"])
def test_served_use_roi(card, served, scene, mode):
    """use_roi on a served set and on one whose reference view is a head
    scene (the landmark branch of face_mask): the card's mask against the
    CPU's (IoU >= 0.99), no valid pixel outside it, the face found."""
    from stereovisionarray_tpu_torch.models import frame_sets_from_dirs, reference_and_sources
    from stereovisionarray_tpu_torch.roi import (
        detect_face,
        detect_face_ellipse,
        ellipse_mask,
        face_mask,
    )

    cams, cfg, dirs, _ = served
    imgs = next(iter(frame_sets_from_dirs(dirs[:1])))
    ref = reference_and_sources(cfg, len(imgs))[0]
    if scene == "head_reference":
        imgs = imgs.copy()
        h, w = imgs.shape[1:]
        imgs[ref] = rec.render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h, fw=0.25 * w,
                                    rng=np.random.default_rng(0))[0]
    x = torch.from_numpy(imgs).cuda()
    out = array_depth_pipeline(x, cams, cfg, use_roi=True, roi_mode=mode)
    image = torch.from_numpy(imgs[ref])
    if mode == "face":
        want = face_mask(image)
    else:
        roi = detect_face_ellipse(image)
        want = ellipse_mask(tuple(image.shape), roi.center, roi.axes, roi.angle) | ~roi.found
    a, b = out.mask.cpu().numpy(), want.cpu().numpy()
    assert (a & b).sum() / max((a | b).sum(), 1) >= 0.99
    assert int((out.valid & ~out.mask).sum()) == 0
    if scene == "head_reference" and mode == "face":
        assert bool(detect_face(x[ref]).found)


@pytest.mark.parametrize("name", ["face", "temporal", "fusion"])
def test_record(card, name):
    """The JAX package's face (EVAL_ROBUST_r05.json level 0), temporal
    (EVAL_TEMPORAL_r05.json level 1; the filter lowers the EPE) and fusion
    (EVAL_FUSION_r04.json) records, each against its tolerance."""
    fn, want, tol = {"face": (rec.face_record, rec.FACE_RECORD, rec.FACE_RECORD_TOL),
                     "temporal": (rec.temporal_record, rec.TEMPORAL_RECORD,
                                  rec.TEMPORAL_RECORD_TOL),
                     "fusion": (rec.fusion_record, rec.FUSION_RECORD, rec.FUSION_RECORD_TOL)}[name]
    got = fn(torch, "cuda")
    assert rec.record_misses(got, want, tol) == {}, got
    if name == "temporal":
        assert got["filtered_epe"] < got["per_frame_epe"], got


# ---- SfM and calibration -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibration(card):
    """calibrate_array at the reference-scale record's scale on the card
    (path (a)), path (b) on the calibrated and the true rig."""
    return rec.reference_scale_calibration(torch, "cuda")


def test_sfm_records(calibration):
    """The reference-scale row against SFM_RECORD (the ATE never above 0.5
    mm), path (b)'s depth against CALIBRATED_DEPTH; the cameras stay on the
    card and carry their host copy."""
    cams = calibration["cameras"]
    assert cams.host_fields is not None and cams.fx.is_cuda
    got = calibration["calibration"]
    assert rec.record_misses(got, rec.SFM_RECORD, rec.SFM_RECORD_TOL) == {}, got
    assert got["ate_mm_calibrated"] < rec.SFM_ATE_CEILING_MM
    assert rec.record_misses(calibration["depth"], rec.CALIBRATED_DEPTH,
                             rec.CALIBRATED_DEPTH_TOL) == {}, calibration["depth"]


def test_record_scale_calibration_runs_are_bit_identical(calibration):
    """A second calibrate_array of the record's scene on the card gives the
    first run's cameras and distortion bit for bit."""
    from stereovisionarray_tpu_torch.models import calibrate_array

    cfg = calibration["cfg"]
    again = calibrate_array(calibration["lensed"], calibration["init"], calibration["ref"],
                            cfg.sfm, rounds=2, estimate_distortion=True)
    _same(again.cameras, calibration["cameras"], ("R", "t"))
    assert tuple(float(k) for k in again.distortion) == tuple(float(k) for k in calibration["k"])


def test_calibrated_depth_path(calibration, launched):
    """Path (b): the 25 undistorted views through array_depth_pipeline on the
    calibrated rig, a general rig (the homography chain, then K2/K3 and K4;
    no K8), every output equal to backend="torch"."""
    views, cams, cfg, ref = (calibration[k] for k in ("views", "cameras", "cfg", "ref"))
    out = array_depth_pipeline(views, cams, cfg, ref_index=ref)
    assert {"svt_sgm_paths", "svt_extract_maps"} <= set(launched), launched
    assert "svt_plane_sweep" not in launched
    _staged(launched)
    plain = array_depth_pipeline(views, cams, cfg, ref_index=ref, backend="torch")
    _same(out, plain, FIELDS)
    _same(out.sweep, plain.sweep, ("plane", "cost", "num_views", "confidence"))
    assert bool(torch.isfinite(out.refined_depth).all())


def test_rectified_two_view_path(card, launched):
    """Path (c): a verged 540x768 pair rectified, two-view SGM at D=64 int8
    (K1, K2/K3, K4 with the LR check inside it) and metric depth, equal to
    backend="torch"; the depth within 1% of the scene's (median)."""
    cams, left, right, gt = rec.verged_pair(torch, "cuda")
    cfg = (config.CostConfig(num_disparities=64, census_window=(7, 9), dtype="int8"), SGM)
    out, depth, lvalid, rect = rec.rectified_two_view(cams, left, right, cfg)
    assert TWO_VIEW <= set(launched) and "svt_lr_gather" not in launched, launched
    assert _extractions(launched) == [True]
    _staged(launched)
    plain = rec.rectified_two_view(cams, left, right, cfg, backend="torch")
    _same(out, plain[0], TWO_VIEW_FIELDS)
    _same(depth, plain[1])
    valid = (out.valid & lvalid & (depth > 0)).cpu().numpy()
    acc = rec.rectified_depth_error(depth.cpu().numpy(), valid, rect, cams, gt)
    assert acc["median_rel_depth_err"] < 0.01 and acc["scored_fraction"] > 0.5, acc


# ---- the command line ----------------------------------------------------------------------------

def _cli_config(argv):
    """The EngineConfig a CLI command line resolves to."""
    return cli.load_config(cli.build_parser().parse_args(argv))


def _cli(argv):
    """cli.main(argv) in-process: its last printed JSON line, its key set
    checked against CLI_KEYS."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0, argv
    torch.cuda.synchronize()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if argv[0] in rec.CLI_KEYS:
        assert sorted(line) == sorted(rec.CLI_KEYS[argv[0]]), argv
    return line


class Artifacts:
    """Each artifact of a CLI run against the same artifact made from the
    port's direct outputs: arrays, PNG pixels and PLY bytes equal."""

    def __init__(self, scratch: Path):
        self.scratch = scratch

    @staticmethod
    def arrays(path, want: dict):
        from stereovisionarray_tpu_torch.datasets import load_array

        got, _ = load_array(str(path))
        assert sorted(got) == sorted(want), path
        for k, v in want.items():
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, (path, k)
            assert np.array_equal(got[k], v, equal_nan=bool(np.issubdtype(v.dtype, np.floating))), (
                path, k)

    def png(self, path, array, **kw):
        from stereovisionarray_tpu_torch.datasets import read_png, save_png

        want = self.scratch / "want.png"
        save_png(str(want), array.detach().cpu().numpy() if torch.is_tensor(array) else array,
                 **kw)
        assert np.array_equal(read_png(str(path)), read_png(str(want))), path

    def ply(self, path, *args, **kw):
        from stereovisionarray_tpu_torch.datasets import save_ply

        want = self.scratch / "want.ply"
        n = save_ply(str(want), *args, **kw)
        assert Path(path).read_bytes() == want.read_bytes(), path
        return n


@pytest.fixture(scope="module")
def cli_data(card, tmp_path_factory):
    """`render` of the default 5x5 rig at 270x360: (scratch, data folder,
    the views as the CLI decodes them, on the card, ground-truth depths)."""
    from stereovisionarray_tpu_torch.datasets import list_images_sorted, load_array, load_image_stack

    scratch = tmp_path_factory.mktemp("cli")
    data = scratch / "data"
    _cli(["render", "--output", str(data)])
    images = torch.from_numpy(load_image_stack(list_images_sorted(str(data)))).cuda()
    return scratch, data, images, load_array(str(data / "ground_truth.npz"))[0]["depths"]


def _depth_direct(images, cams, cfg):
    """What `depth` computes, called directly with backend="torch": (pipeline
    output, points, point validity, colors, reference index)."""
    from stereovisionarray_tpu_torch.geometry import depth_map_to_points, point_cloud_colors

    out = array_depth_pipeline(images, cams, cfg, backend="torch")
    ref = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
    pts, pvalid = depth_map_to_points(cams[ref], out.refined_depth, mask=out.valid)
    return out, pts, pvalid, point_cloud_colors(images[ref], pvalid), ref


@pytest.mark.parametrize("run", ["cross", "to_center", "cascade"])
def test_cli_depth(cli_data, launched, run):
    """`depth` at the CROSS config, the to_center default and the CROSS
    cascade: K8, K2/K3, K4 (K9's 2-D form under --cascade); depth.npz, the
    PNGs and cloud.ply equal to the direct calls', the printed numbers too."""
    from stereovisionarray_tpu_torch.evaluation import masked_mean_error

    scratch, data, images, gt_depths = cli_data
    extra = {"cross": rec.CLI_ARRAY, "to_center": [],
             "cascade": [*rec.CLI_ARRAY, "--cascade"]}[run]
    out_dir = scratch / f"depth_{run}"
    line = _cli(["depth", "--input", str(data), "--output", str(out_dir), *extra])
    needed = {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps"} | (
        {"svt_hat_sample_2d"} if run == "cascade" else set())
    assert needed <= set(launched), launched
    _staged(launched)
    cfg = _cli_config(["depth", "--input", ".", *extra])
    if run == "cascade":
        cfg = cfg.override(**{"plane_sweep.cascade": True})
    cams = cli._rig_from_config(cfg, tuple(images.shape[1:])).to("cuda")
    out, pts, pvalid, col, ref = _depth_direct(images, cams, cfg)
    check = Artifacts(scratch)
    check.arrays(out_dir / "depth.npz", {
        "depth": out.refined_depth, "disparity": out.refined_disparity, "valid": out.valid,
        "confidence": out.sweep.confidence})
    check.png(out_dir / "depth.png", out.refined_depth)
    check.png(out_dir / "disparity.png", out.refined_disparity)
    n = check.ply(out_dir / "cloud.ply", pts.cpu().numpy().reshape(-1, 3),
                  colors=col.cpu().numpy(), valid=pvalid.cpu().numpy().reshape(-1))
    gt = gt_depths[ref]
    d = out.refined_depth.cpu().numpy()
    mask = out.valid.cpu().numpy() & (gt > 0)
    check.png(out_dir / "error.png", np.abs(d - gt) * mask)
    assert line["points"] == n
    assert line["mean_abs_err"] == float(masked_mean_error(
        torch.from_numpy(d), torch.from_numpy(gt), torch.from_numpy(mask)))


def _two_view_cli(scratch, name, lp, rp, extra):
    """`two-view` on (lp, rp), and the same call made directly with
    backend="torch" on the images the CLI decoded: (printed line, output)."""
    from stereovisionarray_tpu_torch.datasets import load_image_gray
    from stereovisionarray_tpu_torch.models import cascade_two_view_disparity

    out_dir = scratch / name
    line = _cli(["two-view", "--left", str(lp), "--right", str(rp), "--output", str(out_dir),
                 *extra])
    args = cli.build_parser().parse_args(["two-view", "--left", ".", "--right", ".", *extra])
    cfg = cli.load_config(args)
    left, right = (torch.from_numpy(load_image_gray(str(p))).cuda() for p in (lp, rp))
    if args.cascade:
        out = cascade_two_view_disparity(
            left, right, cfg.cost, cfg.sgm, coarse_factor=args.coarse_factor,
            fine_disparities=args.fine_disparities, band_step=args.band_step,
            mode=args.cascade_mode, backend="torch")
    else:
        out = two_view_disparity(left, right, cfg.cost, cfg.sgm, backend="torch")
    return line, out, out_dir


FIXTURE = rec.REPO / "data" / "eval_scene"


@pytest.mark.parametrize("run", ["fixture_int16", "fixture_int8", "bench_int8", "cascade"])
def test_cli_two_view(cli_data, launched, run):
    """`two-view` on data/eval_scene at the fixture's config (int16, int8),
    on a bench-shaped 540x768 pair of 8-bit PNGs (D=64, int8) and with
    --cascade at perf_cascade.py's configuration: K1-K4 (K9 under
    --cascade); two_view.npz and the PNGs equal to the direct call's."""
    from stereovisionarray_tpu_torch.datasets import write_png

    scratch = cli_data[0]
    extra = {"fixture_int16": rec.CLI_FIXTURE,
             "fixture_int8": [*rec.CLI_FIXTURE, "--set", "cost.dtype=int8"],
             "bench_int8": rec.CLI_BENCH, "cascade": rec.CLI_CASCADE}[run]
    if run.startswith("fixture"):
        lp, rp = FIXTURE / "im0.png", FIXTURE / "im1.png"
    else:
        if run == "bench_int8":
            pair = rec.stereo_pair(torch, *rec.BENCH_SHAPE[:2], seed=0, integer=True)
        else:
            pair = rec.two_view_cascade_scene(torch, "cpu")[:2]
        lp, rp = scratch / f"{run}_l.png", scratch / f"{run}_r.png"
        for path, a in zip((lp, rp), pair):
            write_png(str(path), np.clip(np.round(a.cpu().numpy()), 0, 255).astype(np.uint8))
    line, out, out_dir = _two_view_cli(scratch, f"two_view_{run}", lp, rp, extra)
    needed = TWO_VIEW | ({"svt_hat_sample"} if run == "cascade" else set())
    assert needed <= set(launched), launched
    if run != "cascade":
        assert "svt_lr_gather" not in launched and _extractions(launched) == [True]
    _staged(launched)
    check = Artifacts(scratch)
    check.arrays(out_dir / "two_view.npz", {"disparity": out.disparity, "valid": out.valid,
                                            "confidence": out.confidence})
    check.png(out_dir / "disparity.png", out.disparity)
    check.png(out_dir / "confidence.png", out.confidence, vmin=0.0, vmax=1.0)
    assert line["valid_fraction"] == float(out.valid.cpu().numpy().mean())


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_cli_evaluate_fixture(cli_data, dtype):
    """`evaluate` of the fixture's `two-view` against its ground truth as a
    .npz: every printed number equal to the metrics called directly, and
    bad-2.0, EPE and density against GOLDEN (the CLI decodes the fixture's
    PNGs to the golden test's images)."""
    from stereovisionarray_tpu_torch.datasets import load_array, load_image_gray, read_pfm, save_array
    from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair
    from stereovisionarray_tpu_torch.evaluation import (
        bad_pixel_ratio,
        end_point_error,
        masked_mean_error,
    )

    scratch = cli_data[0]
    pair = load_middlebury_pair(str(FIXTURE))
    assert np.array_equal(load_image_gray(str(FIXTURE / "im0.png")), pair.left)
    assert np.array_equal(load_image_gray(str(FIXTURE / "im1.png")), pair.right)
    extra = [*rec.CLI_FIXTURE, "--set", f"cost.dtype={dtype}"]
    _, _, out_dir = _two_view_cli(scratch, f"evaluate_{dtype}", FIXTURE / "im0.png",
                                  FIXTURE / "im1.png", extra)
    gt = read_pfm(str(FIXTURE / "disp0.pfm"))
    x = np.arange(gt.shape[1])[None, :]
    with np.errstate(invalid="ignore"):
        matchable = np.isfinite(gt) & (gt > 0) & (x >= np.ceil(gt))
    gt_file = scratch / f"fixture_gt_{dtype}.npz"
    # unmatchable pixels carry 0, so --positive-gt-only masks the golden's pixels
    save_array(str(gt_file), {"disparity": np.where(matchable, gt, 0.0).astype(np.float32)})
    result = out_dir / "two_view.npz"
    line = _cli(["evaluate", "--result", str(result), "--ground-truth", str(gt_file), "--key",
                 "disparity"])
    arrays = load_array(str(result))[0]
    pred = torch.from_numpy(arrays["disparity"]).cuda()
    g = torch.from_numpy(np.where(matchable, gt, 0.0).astype(np.float32)).cuda()
    valid = torch.from_numpy(arrays["valid"]).cuda() & (g > 0)
    direct = {"masked_mean_err": masked_mean_error(pred, g, mask=valid),
              "epe": end_point_error(pred, g, mask=valid),
              **{f"bad_{t}": bad_pixel_ratio(pred, g, t, mask=valid) for t in (0.5, 1.0, 2.0)}}
    assert {k: line[k] for k in direct} == {k: float(v) for k, v in direct.items()}
    got = {"bad_2.0": line["bad_2.0"], "epe": line["epe"],
           "density": line["valid_fraction"] / float(matchable.mean())}
    want = rec.GOLDEN[dtype]
    assert {m: got[m] - want[m] for m in want if abs(got[m] - want[m]) > rec.GOLDEN_TOL} == {}, got


def test_cli_calibrate(cli_data):
    """`calibrate --estimate-distortion` of the 25 rendered views:
    calibration.npz and the printed numbers equal to calibrate_array's."""
    from stereovisionarray_tpu_torch.models import calibrate_array

    scratch, data, images, _ = cli_data
    out_dir = scratch / "calibrate"
    line = _cli(["calibrate", "--input", str(data), "--output", str(out_dir),
                 "--estimate-distortion"])
    cfg = _cli_config(["calibrate", "--input", "."])
    cal = calibrate_array(images, cli._rig_from_config(cfg, tuple(images.shape[1:])),
                          cli._center_index(cfg), cfg.sfm, estimate_distortion=True)
    Artifacts(scratch).arrays(out_dir / "calibration.npz", {
        "R": cal.cameras.R, "t": cal.cameras.t, "points": cal.points,
        "point_valid": cal.point_valid})
    assert {k: line[k] for k in ("num_obs", "mean_reproj_px", "inlier_reproj_px", "k1", "k2")} == {
        "num_obs": int(cal.num_obs), "mean_reproj_px": float(cal.mean_reproj),
        "inlier_reproj_px": float(cal.inlier_reproj), "k1": float(cal.distortion[0]),
        "k2": float(cal.distortion[1])}


def test_cli_reconstruct(cli_data, launched):
    """`reconstruct` of all 25 views at the CROSS config: K8, K2/K3, K4;
    fused_cloud.ply and fused.npz equal to reconstruct_array's."""
    from stereovisionarray_tpu_torch.models.fusion import (
        depth_normals,
        fused_point_cloud,
        reconstruct_array,
    )

    scratch, data, images, _ = cli_data
    out_dir = scratch / "reconstruct"
    _cli(["reconstruct", "--input", str(data), "--output", str(out_dir), *rec.CLI_ARRAY])
    assert {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps"} <= set(launched), launched
    _staged(launched)
    cfg = _cli_config(["reconstruct", "--input", ".", *rec.CLI_ARRAY])
    cams = cli._rig_from_config(cfg, tuple(images.shape[1:])).to("cuda")
    views = tuple(range(len(images)))
    res, _ = reconstruct_array(images, cams, cfg, view_indices=views, backend="torch")
    pts, conf, col = fused_point_cloud(res, images)
    nrm = torch.stack([depth_normals(cams[k], res.depth[k], res.valid[k])[0] for k in views])
    c8 = np.clip(col, 0, 255).astype(np.uint8)
    check = Artifacts(scratch)
    check.ply(out_dir / "fused_cloud.ply", pts, colors=np.stack([c8] * 3, axis=-1),
              normals=nrm.cpu().numpy().reshape(-1, 3)[res.valid.cpu().numpy().reshape(-1)],
              quality=conf)
    check.arrays(out_dir / "fused.npz", {"depths": res.depth, "valid": res.valid,
                                         "support": res.support, "confidence": res.confidence,
                                         "views": np.asarray(views)})


def test_cli_serve(cli_data, served, launched):
    """`serve` of the served test's eight frame-sets, chunks of 4, with the
    temporal filter: K8, K2/K3, K4; every depth .npz and PNG equal to the
    plain pipeline and the filter called directly."""
    from stereovisionarray_tpu_torch.datasets import list_images_sorted, load_image_stack
    from stereovisionarray_tpu_torch.models import (
        array_baselines,
        reference_and_sources,
        temporal_init,
        temporal_update,
    )
    from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth

    scratch, _, images, _ = cli_data
    dirs = served[2]
    out_dir = scratch / "serve"
    line = _cli(["serve", *dirs, "--output", str(out_dir), "--chunk", "4", "--temporal",
                 *rec.CLI_ARRAY])
    assert {"svt_plane_sweep", "svt_sgm_paths", "svt_extract_maps"} <= set(launched), launched
    _staged(launched)
    assert line["frames"] == len(dirs)
    cfg = _cli_config(["serve", ".", *rec.CLI_ARRAY])
    h, w = images.shape[1:]
    cams = cli._rig_from_config(cfg, (h, w)).to("cuda")
    ref, src = reference_and_sources(cfg, len(images))
    b0, f_px = array_baselines(cams, ref, src)[1], float(cams.host().fx[ref])
    state = temporal_init((h, w), "cuda")
    check = Artifacts(scratch)
    for i, d in enumerate(sorted(dirs)):
        x = torch.from_numpy(load_image_stack(list_images_sorted(d))).cuda()
        out = array_depth_pipeline(x, cams, cfg, backend="torch")
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence)
        depth = torch.where(tout.valid, disparity_to_depth(tout.disparity, b0, f_px), 0.0)
        check.arrays(out_dir / f"depth_{i:04d}.npz", {"depth": depth, "valid": tout.valid,
                                                     "stability": tout.stability})
        check.png(out_dir / f"depth_{i:04d}.png", depth)


@pytest.fixture(scope="module")
def cli_cross(cli_data):
    """`depth` at the CROSS config, in-process: its output folder."""
    scratch, data = cli_data[:2]
    out_dir = scratch / "depth_cross_in_process"
    _cli(["depth", "--input", str(data), "--output", str(out_dir), *rec.CLI_ARRAY])
    return out_dir


def test_cli_inspect(cli_data, cli_cross):
    """`inspect` of depth.npz at the centre pixel: each array's value."""
    from stereovisionarray_tpu_torch.datasets import load_array

    h, w = cli_data[2].shape[1:]
    npz = cli_cross / "depth.npz"
    line = _cli(["inspect", str(npz), "--at", str(w // 2), str(h // 2)])
    for k, a in load_array(str(npz))[0].items():
        assert line[k]["at"]["value"] == a[h // 2, w // 2].item(), k


def test_cli_module_in_its_own_process(cli_data, cli_cross):
    """`python -m stereovisionarray_tpu_torch depth` in its own process writes
    the in-process run's depth.npz and cloud.ply."""
    from stereovisionarray_tpu_torch.datasets import load_array

    scratch, data = cli_data[:2]
    out_dir = scratch / "depth_cross_process"
    proc = subprocess.run([sys.executable, "-m", "stereovisionarray_tpu_torch", "depth",
                           "--input", str(data), "--output", str(out_dir), *rec.CLI_ARRAY],
                          cwd=rec.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    Artifacts(scratch).arrays(out_dir / "depth.npz", load_array(str(cli_cross / "depth.npz"))[0])
    assert (out_dir / "cloud.ply").read_bytes() == (cli_cross / "cloud.ply").read_bytes()
