#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its result
line):
 1. device: the card's name and power limit from nvidia-smi;
 2. build: compiles the kernels under stereovisionarray_tpu_torch/csrc;
 3. kernel parity: K1 (cost volume), K2/K3 (SGM path scans), K4 (extraction
    maps) and K5 (LR gather) against their plain PyTorch versions on the same
    CUDA tensors, bit-exact, at 540x768 D=64 (int8, int16) and 541x766 D=48;
 4. main path: two_view_disparity on the card at bench.py's shape
    (540x768, D=64, int8) and at __graft_entry__.entry()'s (256x384, D=64,
    int16), bit-exact to the plain path on the card; every kernel's launch
    count from this phase must be > 0;
 5. golden fixture: data/eval_scene through the port's loader, int16 and int8,
    metrics equal to the reference's pallas_interpret values to 1e-6;
 6. timing with CUDA events: end to end and per kernel beside the plain
    versions, one JSON line each.
The camera-array slice adds, after its two-view counterpart each:
 3b. K8 parity: the fused plane sweep against its plain version on the same
    CUDA tensors, bit-exact (fused cost and view count), on rendered
    (non-integer) 5x5 rigs at 270x360 D=128 CROSS (4 sources, plain mean),
    to_center (24 sources, top-6), valid mean, patch 3 and 7, and 271x361
    D=97;
 4b. array main path: array_depth_pipeline at bench_array.py's config
    (5x5, 270x360, 128 planes, CROSS) and at the to_center default, every
    output bit-exact to backend="torch" on the card; the launch counts of K8,
    K2/K3 and K4 from this phase must be > 0;
 5b. array golden: the scripts/make_array_eval.py setup with integer images,
    metrics against ARRAY_GOLDEN; the raw-float metrics are printed beside
    EVAL_ARRAY_r05.json for the record;
 6b. array timing: ms per frame-set, kernel and plain, and K8, K2/K3 and K4
    at D=128 beside their plain versions.
The cascade slice adds, after the array phases each:
 3c. K9 parity: the hat sampler against its plain version on the same CUDA
    tensors, bit-exact, at the cascades' shapes (the two-view residual warp
    with its aux table, the two-view decode, the array pre-warp along rows and
    along columns for all sources in one launch) and with t far outside the
    tap range;
 4c. cascade main paths: cascade_two_view_disparity at scripts/perf_cascade.py's
    configuration (540x768, 256 disparities, int8) on its large-range scene,
    and array_depth_pipeline with plane_sweep.cascade at
    scripts/perf_cascade_sweep.py's (5x5, 270x360, 128 planes, CROSS), each
    bit-exact to backend="torch" on the card in every output, in smooth and
    band mode; K1-K5 must launch on the two-view cascade and K8, K2/K3 and K4
    on the array cascade, and K9 on both in smooth mode (band mode warps and
    decodes by gathers);
 5c. cascade accuracy: the metrics of both perf scripts against
    CASCADE_GOLDEN; the TPU values of EVAL_CASCADE*_r05.json are printed
    beside them for the record;
 6c. cascade timing: each cascade beside its flat pipeline, and K9 beside its
    plain version at the cascades' shapes.
The float-cost slice adds, after the cascade phases each:
 3d. float kernel parity, max_abs_err 0 on the same CUDA tensors: the float
    SGM scans and ordered combine K7 at 540x768x64 and 541x766x48, 4 and 8
    paths, adaptive P2, in every order (k7, wdh, k10, k12), the K11 pair; the
    extraction K6 over float32, int8 and int16 volumes with uniqueness and
    LR; K1's float32 store;
 4d. float main paths, every output bit-exact to backend="torch":
    two_view_disparity with float32 costs at the bench and entry shapes,
    array_depth_pipeline with plane_sweep.cost="zncc" (float SGM) and
    plane_sweep_depth with sgm_cfg=None (raw WTA) at bench_array.py's CROSS
    shape; K7 and K6 must launch; then the K10-K12 entry points at the bench
    shape, which no pipeline calls, each counted;
 5d. float golden: data/eval_scene with float32 costs against FLOAT_GOLDEN to
    1e-6 (EVAL_r03.json printed beside it, ungated);
 6d. float timing: two-view float32 ms/frame beside int8, the ZNCC array ms
    per frame-set, and K6, K7, K10-K12 beside their plain versions.
The redesign of K2/K3 and K8 adds, within the phases above:
 3. K2/K3 on int16 costs whose 8-path total wraps, and at 540x768x256;
 3b. K8 with shifts that move by more than a tile within a chunk of planes,
    and on its generic kernel (patch 9, top-9);
 4. the integer scans' wrapper runs no zero-fill and no narrowing copy (the
    ops it calls, from the profiler), and returns the kernel's int16 total.
The redesign of K5 and K9 changes, within the phases above:
 3. the extraction with K5's LR check fused into it (K4's launch; the row
    "K5 lr_check fused") against its plain route, with and without the right
    map, here on the integer totals and in 3d on int8, int16 and float32
    volumes; the standalone K5 stays held to its plain version;
 3c. K9's 2-D form (the array pre-warp in one launch) against its plain
    version and against two K9 launches;
 4-4d. a run also counts the C entry points it launched: the integer paths
    launch no standalone K5 (svt_lr_gather) and one extraction per frame, K6
    with LR is one launch, the array cascade's pre-warp is one 2-D K9 launch
    and no 1-D one; the standalone K5 runs once as an entry point in 4d;
 6-6d. every kernel's device time beside its wrapper time (device_ms).
The redesign of K4 and K6 (a tile of the row staged in shared memory) adds:
 3e. the extraction at every shape, volume type and LR setting a path gives
    it (EXTRACT_ROWS: the two-view int16 totals at D=64 and 256, float32 at
    D=64, the array's int16 total, int8 and float32 volumes at 270x360x128)
    and float32 at D=256 with LR, against its plain version: the plan must
    be tiled at every path's row and generic at the last;
 4-4d. a line naming the form of every extraction the paths launched (it
    fails on the generic form);
 6. K4 at D=256 with LR and at the array's shape, timed beside its plain
    version and bound ("at_shapes" in K4's row of the kernels line).
The redesign of K7 (the float sum's vertical groups in row strips kept in
L2) adds:
 3d. K7's strip route at every K7_STRIP_ROWS shape (both parity shapes in
    every order, the array's ZNCC volume in wdh, an image narrower than its
    strip height), 4 and 8 paths, and its generic form on a sweep subset and
    under sweep_pair, each held to its plain version and to its route (the
    wrapper's two counts);
 4d. the float paths must not run the generic form; a sweep subset runs it
    as an entry point ("K7 generic");
 6d. the strip route at the array's ZNCC shape ("at_shapes" in its row).
The redesign of K1 (the rows staged once, a census a pixel, runs of
disparities stored 16 bytes at a time) adds:
 3f. K1 at every K1_ROWS shape (int8, int16 and float32 at 540x768x64, the
    entry and golden shapes, 540x768x256, the two-view cascade's coarse and
    fine passes, 541x766x48) against its plain version, bit-exact, BT on and
    off at the bench shape: the plan must be tiled at every path's row and
    generic at the last (47 bytes a pixel);
 4-4d. a line naming the form of every cost volume the paths launched (it
    fails on the generic form);
 6. K1 at the other shapes the paths give it ("at_shapes" in its row), each
    bound counting the volume's element size.
The served capture path (face ROI, the temporal filter, the streaming serve
loop, multi-view fusion) adds, after the phases above:
 4e. served path: 8 frame-sets of bench_array.py's config (5x5, 270x360, 128
    planes, CROSS) written as PNGs and decoded by frame_sets_from_dirs (the
    decoder that ran is printed), served by stream_depth_maps(depth=2) and
    stream_depth_maps_chunked(chunk=4, temporal=TemporalParams(...)) with the
    rig's tensors on the card: every output bit-exact to direct
    array_depth_pipeline calls and the port's filter over them, set 0 bit-exact
    to backend="torch"; use_roi in both modes, on a served set and on one whose
    reference view is a head scene, each mask against the CPU's by IoU; K8,
    K2/K3 and K4 must launch;
 5e. records of the JAX package's EVAL files, each against its tolerance:
    the face detector over the 12 head scenes (EVAL_ROBUST_r05.json level 0),
    the temporal filter on data/eval_scene at noise level 1
    (EVAL_TEMPORAL_r05.json; the filtered EPE must also stay below the
    per-frame EPE), reconstruct_array on the 5x5 rig at 135x180
    (EVAL_FUSION_r04.json);
 6e. served timing: frame-sets per second of the served loop against a serial
    loop (in turns), its decode share and the host time inside each pipeline
    call, the chunked loop with the filter, and temporal_update, face_mask,
    fuse_depth_maps and reconstruct_array.
SfM and calibration add, after the served phases:
 4f. calibrate_array at EVAL_SFM_r05.json's scale (path (a): 5x5 at 270x360,
    a k1 = -0.2, k2 = 0.03 lens, a 1 cm guess, the distortion solve), whose
    cameras must stay on the card and carry their host copy; then, counted,
    path (b): the 25 views undistorted with the estimated (k1, k2) through
    array_depth_pipeline at bench_array.py's CROSS config on the calibrated
    rig (a general rig: the homography chain, then K2/K3 and K4, no K8), and
    path (c): a verged 540x768 pair rectified (rectify_pair, rectify_images),
    two_view_disparity at D=64 int8 (K1, K2/K3, K4 with K5's fused check) and
    rectified_disparity_to_depth, each bit-exact to backend="torch" on the
    card; path (c)'s depth within 1% of the scene's (median);
 5f. the reference-scale record against SFM_RECORD (k2 printed, not gated;
    the ATE never above 0.5 mm) and path (b)'s depth against
    CALIBRATED_DEPTH, the true rig's run on the same views beside it;
 6f. calibrate_array's wall and device time with its stages (build_tracks,
    the distortion solve, each round's triangulation + BA), three runs
    bit-identical, its device events and busy share; the 25-view
    undistortion; path (b) per frame-set beside the true rig's translation
    route (K8); path (c) per frame (whole, and with rectify_pair computed once
    per rig) beside the plain two-view frame.
The command line adds, after the SfM phases:
 4g. every subcommand through cli.main in-process, counted: render of the
    default 5x5 rig at 270x360; depth at bench_array.py's CROSS config, at
    the to_center default and with --cascade; two-view on data/eval_scene at
    the fixture's config in int16 and int8, on a bench-shaped 540x768 pair
    (8-bit PNGs, D=64, int8) and with --cascade at perf_cascade.py's
    configuration; evaluate of the fixture runs; calibrate
    --estimate-distortion of the 25 views; reconstruct of all 25 at CROSS;
    serve of phase 4e's eight frame-sets with --chunk 4 --temporal; inspect.
    Every .npz array, PNG pixel and PLY byte equals the port's functions
    called directly with backend="torch" on the images the CLI decoded, every
    printed key set is CLI_KEYS', K8, K2/K3 and K4 launch on depth,
    reconstruct and serve, K1-K4 on two-view and K9 on both cascades; then
    `python -m stereovisionarray_tpu_torch depth` in its own process writes
    the in-process CROSS run's depth.npz and cloud.ply;
 5g. the fixture's evaluate numbers against GOLDEN to 1e-6 (the CLI decodes
    the fixture's gray PNGs to phase 5's images);
 6g. each subcommand's wall beside the direct call it wraps (the CLI's own
    decode, copies and writes), and the `python -m` process's wall.
The refinement's kernel R (csrc/refine.cu, the static-stack pass) adds:
 4b. on the array main path (CROSS and to_center), three R launches a pass,
    the pipeline bit-exact to backend="torch" (the plain refinement), and R
    against its plain route at both passes (4 views whole-step, 24 views hat
    blend, radius 5, window 21, the sweep's disparities), every output,
    limit 0; the array cascade and ZNCC paths must launch R too;
 6b. R at both passes beside its plain route (R's row of the kernels line
    is the CROSS pass).
The line before the last lists every kernel with its launches, parity error,
wrapper time, device time, plain time, bound (the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s) and the wrapper and device
times of one PyTorch library call that computes the same function, where
there is one; the last line is the result. Needs no network and no JAX.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BENCH_SHAPE = (540, 768, 64)  # bench.py:46
ENTRY_SHAPE = (256, 384, 64)  # __graft_entry__.py:36-38
# golden metrics of the reference's integer path (backend="pallas_interpret")
# on data/eval_scene with the scripts/make_eval_fixture.py config
GOLDEN = {
    "int16": {"bad_2.0": 0.0073033, "epe": 0.2927659, "density": 0.9592620},
    "int8": {"bad_2.0": 0.0072615, "epe": 0.2922293, "density": 0.9592108},
}
GOLDEN_TOL = 1e-6
ARRAY_SHAPE = (5, 5, 270, 360, 128)  # bench_array.py:29-31: rows, cols, H, W, planes
# metrics of the reference's kernel route on the scripts/make_array_eval.py:43-55
# setup (5x5 @ 135x180, 96 planes, CROSS, refine radius 3, window 11) with
# np.round images: plane_sweep_depth(..., backend="pallas_interpret") and the
# refine loop of models/array_pipeline.py:243-273, on the CPU with JAX
# (interior [8:-8, 8:-8] of the valid pixels, as make_array_eval.py:60-62)
ARRAY_GOLDEN = {
    "median_rel_depth_err_sweep": 0.0006575514562427998,
    "median_rel_depth_err_refined": 0.00045502185821533203,
    "frac_rel_err_lt_1pct_refined": 0.9923652387784382,
    "density": 1.0,
}
# the port on the CPU and on the card lands 3.7e-8 (sweep) and 0 (refined) from
# these values, so the bound is tightened from the 2e-5 first allowed to 1e-6
ARRAY_GOLDEN_TOL = {"median_rel_depth_err_sweep": 1e-6, "median_rel_depth_err_refined": 1e-6,
                    "frac_rel_err_lt_1pct_refined": 1e-6, "density": 0.0}
# the reference's XLA float route on raw float images (EVAL_ARRAY_r05.json), for the record
EVAL_ARRAY_R05 = {"median_rel_depth_err_sweep": 0.00069, "median_rel_depth_err_refined": 0.00048,
                  "frac_rel_err_lt_1pct_refined": 0.9928, "density": 1.0}
ARRAY_FRAMES = 10
TIMED_FRAMES = 20
PLAIN_FRAMES = 3  # the plain path runs thousands of small launches a frame
CASCADE_SHAPE = (540, 768, 256)  # scripts/perf_cascade.py:35-40: H, W, total disparities
# scripts/perf_cascade_sweep.py:42-45,77-92: the array cascade over the CROSS bench shape
ARRAY_CASCADE = {"plane_sweep.topology": "CROSS", "plane_sweep.cascade": True,
                 "plane_sweep.cascade_coarse_factor": 4, "plane_sweep.cascade_fine_planes": 48,
                 "plane_sweep.cascade_band_step": 8}
# the reference's kernel route (backend="pallas_interpret") at full size, with JAX on
# the CPU: perf_cascade.py:180-192's metrics of cascade_two_view_disparity on
# make_scene(rng 0), and perf_cascade_sweep.py:143-157's of the array cascade (its
# cascade_plane_sweep_depth and the refine loop of models/array_pipeline.py)
CASCADE_GOLDEN = {
    "two_view": {"valid_in_mask": 0.994552595872313, "bad2": 0.0004652926173571379,
                 "epe": 0.11263467371463776, "median_err": 0.0914764404296875},
    "array": {"valid_inner": 1.0, "median_rel": 0.0013529658317565918,
              "mean_rel": 0.0015273640165105462, "bad2pct": 0.0005951290972349386},
}
# The smooth cascades' float glue (box filters, column means, resize) sums in
# PyTorch's order, not XLA's, which moves census bits at near-ties. From these
# values the port lands, on the CPU, 8.6e-6 / 3.2e-6 / 9.8e-6 px / 7.6e-6 px
# (two-view) and 0 / 1.2e-7 / 1.3e-11 / 0 (array); on an H100, 1.7e-5 / 8e-9 /
# 3.0e-6 px / 1.5e-5 px and 0 / 1.2e-7 / 2.6e-9 / 0. The bounds keep about 3x
# over the larger gap.
CASCADE_GOLDEN_TOL = {
    "two_view": {"valid_in_mask": 5e-5, "bad2": 5e-5, "epe": 1e-4, "median_err": 1e-4},
    "array": {"valid_inner": 0.0, "median_rel": 1e-6, "mean_rel": 1e-6, "bad2pct": 2e-5},
}
# the reference on a TPU v5e (EVAL_CASCADE_r05.json, EVAL_CASCADE_SWEEP_r05.json), for the record
EVAL_CASCADE_R05 = {
    "two_view": {"valid_in_mask": 0.9945, "bad2": 0.00047, "epe": 0.1128, "median_err": 0.0915},
    "array": {"valid_inner": 1.0, "median_rel": 0.001341, "mean_rel": 0.001509, "bad2pct": 0.00057},
}
# the reference's float32 route (backend="pallas_interpret": float cost ->
# sgm_aggregate_pallas_hdw -> extract_disparity_hdw) on data/eval_scene with the
# scripts/make_eval_fixture.py SGM config, computed with JAX on the CPU at full size
# (tests/test_torch_golden.py::test_float_golden_is_the_reference_route)
FLOAT_GOLDEN = {"bad_2.0": 0.007297772914171219, "epe": 0.2934589385986328,
                "density": 0.9592484831809998}
FLOAT_GOLDEN_TOL = 1e-6
ELEMENT_BYTES = {"int8": 1, "int16": 2, "float32": 4}
# H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the extraction (K4 / K6) at every shape a path gives it: (path, kernel,
# (H, W, D), volume type, LR check). The two-view paths check LR and leave
# the right map out; the array paths (models/plane_sweep.py:298,306,310)
# neither check nor ask for it.
EXTRACT_ROWS = (
    ("two_view_bench", "K4", (540, 768, 64), "int16", True),
    ("two_view_entry", "K4", (256, 384, 64), "int16", True),
    ("two_view_float32", "K6", (540, 768, 64), "float32", True),
    ("two_view_flat_d256", "K4", (540, 768, 256), "int16", True),
    ("array_sgm", "K4", (270, 360, 128), "int16", False),
    ("array_no_sgm", "K6", (270, 360, 128), "int8", False),
    ("array_zncc", "K6", (270, 360, 128), "float32", False),
    ("float32_d256_lr", "K6", (540, 768, 256), "float32", True),  # no path: the generic form
)
# K7's strip route at the float paths' shapes and the parity shapes, with the
# orders held there: the two-view bench shape and the odd parity shape in
# every order, the array's ZNCC volume in its wdh order, and one image
# narrower than its strip height (S = 32)
K7_STRIP_ROWS = (
    ((540, 768, 64), ("k7", "wdh", "k10", "k12")),
    ((541, 766, 48), ("k7", "wdh", "k10", "k12")),
    ((270, 360, 128), ("wdh",)),
    ((75, 20, 64), ("k7", "k12")),
)
# the cost volume K1 at every shape a path gives it, and the odd parity shape:
# (row, (H, W, D), census window, volume type). The two-view cascade's coarse
# pass runs at a quarter of 540x768 with a 5x7 census and 64 disparities, its
# fine pass at 24 (models/cascade.py:200-240, chip_smoke's cascade config);
# the last row (47 bytes a pixel) is the generic form's: no path gives it.
K1_ROWS = (
    ("two_view_bench_int8", (540, 768, 64), (7, 9), "int8"),
    ("two_view_bench_int16", (540, 768, 64), (7, 9), "int16"),
    ("two_view_bench_float32", (540, 768, 64), (7, 9), "float32"),
    ("two_view_entry", (256, 384, 64), (7, 9), "int16"),
    ("golden_int16", (540, 720, 64), (7, 9), "int16"),
    ("golden_float32", (540, 720, 64), (7, 9), "float32"),
    ("two_view_flat_d256", (540, 768, 256), (7, 9), "int8"),
    ("cascade_coarse", (135, 192, 64), (5, 7), "int8"),
    ("cascade_fine", (540, 768, 24), (7, 9), "int8"),
    ("parity_int8", (541, 766, 48), (7, 9), "int8"),
    ("parity_int16", (541, 766, 48), (7, 9), "int16"),
    ("parity_float32", (541, 766, 48), (7, 9), "float32"),
    ("generic_d47", (541, 766, 47), (7, 9), "int8"),  # no path: the generic form
)


def extraction_volume(torch, h, w, D, vtype):
    """The volume a path hands the extraction at (h, w, D), from a seeded
    pair: int16 the SGM total of int8 costs, int8 the raw costs, float32 the
    float SGM total (raw float costs at D = 256)."""
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.sgm import p2_maps
    from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float, sgm_aggregate_paths

    left, right = stereo_pair(torch, h, w, seed=D)
    costs = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0,
                                   "float32" if vtype == "float32" else "int8")
    if vtype == "int16":
        py, px = p2_maps((h, w), 96, torch.int16, left.device, left, True, 24)
        return sgm_aggregate_paths(costs, py, px, 8, 8)
    if vtype == "float32" and D < 256:
        py, px = p2_maps((h, w), 96.0, torch.float32, left.device, left, True, 24.0)
        return sgm_aggregate_float(costs, py, px, 8.0, 8)
    return costs


def k1_bound(h, w, D, window, element_bytes, as_ms=True):
    """K1's least work: both images read once and the (h, w, D) volume of
    `element_bytes` written once; two operations a census word (XOR,
    popcount) and 14 for BT and the store an element. As (bytes, operations),
    or as ms over the H100's HBM rate and float32 peak."""
    n_words = -(-(window[0] * window[1] - 1) // 64)
    nbytes = 2 * h * w * 4 + h * w * D * element_bytes
    ops = h * w * D * (2 * n_words + 14)
    if not as_ms:
        return nbytes, ops
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def extraction_call(extract_maps, extract_disparity_maps, kernel, vol, lr, right=False):
    """The extraction a path runs on `vol`: backend -> maps."""
    if kernel == "K4":
        return lambda b: extract_maps(vol, True, 0.95 if lr else 0.0, b,
                                      lr_max_diff=1.5 if lr else 0.0, right=right)
    return lambda b: extract_disparity_maps(vol, True, 0.95 if lr else 0.0, 1.5 if lr else 0.0, b)


def two_view_cascade_config(CostConfig, SGMConfig):
    """scripts/perf_cascade.py:118-128: (cost, sgm, cascade keyword arguments)."""
    return (CostConfig(num_disparities=CASCADE_SHAPE[2], dtype="int8"),
            SGMConfig(p1=8.0, p2=96.0, num_paths=8),
            dict(coarse_factor=4, fine_disparities=24, band_step=8))


def two_view_cascade_scene(torch, device):
    """perf_cascade.py's make_scene(rng 0) at CASCADE_SHAPE: (left, right) on
    `device`, and the gt disparity and eval mask in numpy."""
    from stereovisionarray_tpu_torch.datasets.synthetic import large_range_pair

    left, right, gt, mask = large_range_pair(np.random.default_rng(0), *CASCADE_SHAPE[:2])
    return torch.from_numpy(left).to(device), torch.from_numpy(right).to(device), gt, mask


def two_view_cascade_run(left, right, mode="smooth", backend="auto"):
    """cascade_two_view_disparity at perf_cascade.py's configuration."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.models import cascade_two_view_disparity

    cost, sgm, kw = two_view_cascade_config(config.CostConfig, config.SGMConfig)
    return cascade_two_view_disparity(left, right, cost, sgm, mode=mode, backend=backend, **kw)


def two_view_cascade_metrics(torch, device) -> dict:
    from stereovisionarray_tpu_torch.evaluation import cascade_disparity_metrics

    left, right, gt, mask = two_view_cascade_scene(torch, device)
    return cascade_disparity_metrics(two_view_cascade_run(left, right).disparity, gt, mask)


def array_cascade_scene(torch, device):
    """perf_cascade_sweep.py's rig and scene: (cameras, images, depths, config)."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array

    rows, cols, h, w, planes = ARRAY_SHAPE
    cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(h, w))
    images, depths = render_camera_array(cams, (h, w))
    cfg = config.EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                            "plane_sweep.num_planes": planes, **ARRAY_CASCADE})
    return cams, torch.from_numpy(images).to(device), depths, cfg


def array_cascade_metrics(torch, device) -> dict:
    from stereovisionarray_tpu_torch.evaluation import cascade_depth_metrics
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    cams, images, depths, cfg = array_cascade_scene(torch, device)
    out = array_depth_pipeline(images, cams, cfg)
    ref_index = (ARRAY_SHAPE[0] // 2) * ARRAY_SHAPE[1] + ARRAY_SHAPE[1] // 2
    return cascade_depth_metrics(out.refined_depth, out.valid, depths[ref_index])


def gauss_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur, edge-clamped (numpy only; a copy of
    scripts/make_robust_eval.py:50-68)."""
    if sigma <= 1e-6:
        return img
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()

    def along(a, axis):
        ap = np.take(a, np.clip(np.arange(-r, a.shape[axis] + r), 0, a.shape[axis] - 1),
                     axis=axis)
        return np.apply_along_axis(lambda v: np.convolve(v, k, mode="valid"), axis, ap)

    return along(along(img.astype(np.float64), 0), 1).astype(np.float32)


def perturb_views(views: np.ndarray, level: int, rng: np.random.Generator) -> np.ndarray:
    """The EVAL_ROBUST severity model on (N, H, W) views in [0, 255], each
    view on its own: gain, bias, defocus, read and shot noise at `level` (a
    copy of scripts/make_robust_eval.py:71-87, which imports JAX)."""
    if level == 0:
        return views.astype(np.float32)
    L = float(level)
    out = []
    for v in views:
        g = rng.normal(1.0, 0.03 * L)
        b = rng.normal(0.0, 4.0 * L)
        img = v.astype(np.float64) * g + b
        sigma_blur = max(0.0, 0.4 * L * rng.uniform(0.8, 1.2))
        img = gauss_blur(np.asarray(img, np.float32), sigma_blur)
        img = img + rng.normal(0.0, 2.0 * L, img.shape)
        img = img + rng.standard_normal(img.shape) * (0.25 * L * np.sqrt(np.maximum(img, 0.0)))
        out.append(np.clip(img, 0.0, 255.0))
    return np.asarray(out, np.float32)


def render_head(h=180, w=240, cu=130.0, cv=80.0, fw=60.0, bright_bg=True, rng=None):
    """A rendered head scene: a skin oval with eye, brow and mouth features
    at face width fw over a brighter (or darker) background; (image, oval)
    (a copy of tests/test_roi.py:141-166)."""
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), 225.0 if bright_bg else 40.0, np.float32)
    img += 20.0 * (uu / w)  # background gradient
    fh = fw * 56.0 / 44.0
    un = (uu - (cu - fw / 2)) / fw
    vn = (vv - (cv - fh / 2)) / fh
    oval = ((un - 0.5) / 0.48) ** 2 + ((vn - 0.52) / 0.52) ** 2 <= 1.0
    img[oval] = 140.0  # skin

    def blob(bu, bv, su, sv):
        return np.exp(-0.5 * (((un - bu) / su) ** 2 + ((vn - bv) / sv) ** 2))

    img -= 70.0 * blob(0.30, 0.35, 0.10, 0.05)  # eyes
    img -= 70.0 * blob(0.70, 0.35, 0.10, 0.05)
    img -= 40.0 * blob(0.26, 0.24, 0.12, 0.03)  # brows
    img -= 40.0 * blob(0.74, 0.24, 0.12, 0.03)
    img -= 55.0 * blob(0.50, 0.78, 0.15, 0.05)  # mouth
    if rng is not None:
        img += rng.normal(0, 3.0, img.shape).astype(np.float32)
    return img, oval


SERVED_SETS = 8  # frame-sets through the served path (phase 4e)
# accuracy records of the JAX package (phase 5e), each with the tolerance the
# port is held to: about 3x the port's own gap from the record, measured on
# the CPU (the kernels' plain twins). The records are rounded, and the
# temporal and fusion ones came from the reference's default routes (the
# two-view float oracle on the CPU; the r04 array code), not its int16 path.
# EVAL_ROBUST_r05.json level_0 face; the port on the CPU: 1.0, 0.893218
FACE_RECORD = {"detection_rate": 1.0, "mean_score": 0.8932}
FACE_RECORD_TOL = {"detection_rate": 0.0, "mean_score": 2e-4}
# EVAL_TEMPORAL_r05.json level_1, last frame; the port on the CPU: 0.876441,
# 0.681285, 0.833913 (per-frame density 0.793517, the record's 0.7925)
TEMPORAL_RECORD = {"per_frame_epe": 0.8736, "filtered_epe": 0.6788, "filtered_density": 0.8331}
TEMPORAL_RECORD_TOL = {"per_frame_epe": 0.01, "filtered_epe": 0.01, "filtered_density": 0.003}
# EVAL_FUSION_r04.json; the port on the CPU: 40606 points, 14.5116, 0.000556797
FUSION_RECORD = {"points_fused": 40546, "dedup_ratio": 14.53,
                 "median_rel_depth_err_fused": 0.000534}
FUSION_RECORD_TOL = {"points_fused": 180, "dedup_ratio": 0.06,
                     "median_rel_depth_err_fused": 7e-5}
TEMPORAL_FRAMES = 8  # scripts/make_temporal_eval.py:44
# the 12 head scenes of scripts/make_robust_eval.py:160-178 (4 geometries x
# seeds 0-2, both background polarities)
FACE_CASES = (dict(cu=130.0, cv=80.0, fw=60.0, bright_bg=True),
              dict(cu=90.0, cv=100.0, fw=80.0, bright_bg=True),
              dict(cu=150.0, cv=90.0, fw=48.0, bright_bg=False),
              dict(cu=110.0, cv=70.0, fw=70.0, bright_bg=False))


def face_record(torch, device) -> dict:
    """EVAL_ROBUST_r05.json's face protocol at level 0 (make_robust_eval.py
    face_metrics): detect_face over the 12 head scenes."""
    from stereovisionarray_tpu_torch.roi import detect_face

    found, scores = [], []
    rng = np.random.default_rng(300)
    for case in FACE_CASES:
        for seed in range(3):
            img, _ = render_head(rng=np.random.default_rng(seed), **case)
            img = perturb_views(img[None], 0, rng)[0]
            det = detect_face(torch.from_numpy(img).to(device))
            found.append(bool(det.found))
            scores.append(float(det.score))
    return {"detection_rate": float(np.mean(found)), "mean_score": float(np.mean(scores)),
            "cases": len(found)}


def temporal_record(torch, device) -> dict:
    """EVAL_TEMPORAL_r05.json's level 1 (scripts/make_temporal_eval.py): T = 8
    independently noised frames of data/eval_scene (seed 101) through the
    int16 two-view path, filtered with max_diff 1.5; EPE and density of the
    last frame, per frame and filtered, on the GT-known matchable pixels."""
    from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
    from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair
    from stereovisionarray_tpu_torch.models.temporal import temporal_filter_sequence
    from stereovisionarray_tpu_torch.models.two_view import two_view_disparity

    pair = load_middlebury_pair(str(REPO / "data" / "eval_scene"))
    gt = pair.gt_disparity
    matchable = pair.valid_gt & (np.arange(pair.left.shape[1])[None, :] >= np.ceil(gt))
    cost_cfg = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9))
    sgm_cfg = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True, uniqueness=0.95,
                        lr_max_diff=1.5)
    rng = np.random.default_rng(101)
    ds, vs, cs = [], [], []
    for _ in range(TEMPORAL_FRAMES):
        left, right = perturb_views(np.stack([pair.left, pair.right]), 1, rng)
        out = two_view_disparity(torch.from_numpy(left).to(device),
                                 torch.from_numpy(right).to(device), cost_cfg, sgm_cfg)
        ds.append(out.disparity)
        vs.append(out.valid)
        cs.append(out.confidence)
    outs = temporal_filter_sequence(torch.stack(ds), torch.stack(vs), torch.stack(cs),
                                    max_diff=1.5)

    def metrics(d, v):
        vv = v.cpu().numpy() & matchable
        err = np.abs(d.cpu().numpy() - gt)[vv]
        return float(err.mean()), float(vv.mean() / matchable.mean())

    (pf_epe, pf_density), (f_epe, f_density) = metrics(ds[-1], vs[-1]), metrics(
        outs.disparity[-1], outs.valid[-1])
    return {"per_frame_epe": pf_epe, "per_frame_density": pf_density, "filtered_epe": f_epe,
            "filtered_density": f_density}


def fusion_config():
    """scripts/make_fusion_eval.py:48-56: the 5x5 rig at 135x180, 96 planes,
    CROSS, refine radius 2."""
    from stereovisionarray_tpu_torch.config import EngineConfig

    return EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                      "plane_sweep.num_planes": 96,
                                      "plane_sweep.topology": "cross", "refine.radius": 2})


def fusion_record(torch, device, reconstruct=None) -> dict:
    """EVAL_FUSION_r04.json's protocol (make_fusion_eval.py): reconstruct_array
    over every view of the rig, rel_thresh 0.01, min_support 3; the kept
    points' depth error against each view's exact depth."""
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.models.fusion import reconstruct_array

    res = (135, 180)
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=res)
    images, gt = render_camera_array(cams, res)
    result, depths = (reconstruct or reconstruct_array)(
        torch.from_numpy(images).to(device), cams.to(device), fusion_config(), rel_thresh=0.01,
        min_support=3)
    kept = result.valid.cpu().numpy()
    rel = np.abs(result.depth.cpu().numpy() - gt) / np.maximum(gt, 1e-9)
    per_view_valid = int((depths > 0).sum())
    n_points = int(kept.sum())
    return {"points_fused": n_points, "per_view_valid_pixels": per_view_valid,
            "dedup_ratio": per_view_valid / max(n_points, 1),
            "median_rel_depth_err_fused": float(np.median(rel[kept]))}


# SfM and calibration (phases 4f-6f). EVAL_SFM_r05.json's reference-scale row
# (scripts/make_sfm_eval_r05.py:62-76): the 5x5 rig at 270x360, a k1 = -0.2,
# k2 = 0.03 lens, a 1 cm RMS guess from default_rng(1), SfMConfig(max_features
# 512, ba_iterations 30, ba_damping 1e-3), 2 rounds, the distortion solve.
# The calibration sits in a flat valley of its cost: the JAX package's own
# stages called one by one (each jitted alone) instead of under one jit land
# at ATE 0.19523 mm and inlier reprojection 0.028769 px against the record's
# 0.19691 and 0.033238, and so does the port on the CPU (0.19522, 0.028768;
# k1 -0.1913765 against -0.1913755; counts equal). The bounds are about 3x
# those gaps (ATE 0.0017 mm, reprojection 0.0045 px); the counts are exact,
# the initial ATE is the same numpy perturbation, k1 and the outlier share are
# held to the record's rounding; k2 is printed, not gated (it wanders along
# the (k1, k2) ridge, the record's own note).
SFM_SHAPE = (5, 5, 270, 360)
SFM_RECORD = {"ate_mm_initial": 13.658, "ate_mm_calibrated": 0.197, "observations": 7660,
              "tracks": 502, "inlier_reproj_px": 0.0332, "outlier_fraction": 0.0004,
              "k1": -0.1914}
SFM_RECORD_TOL = {"ate_mm_initial": 5e-4, "ate_mm_calibrated": 0.006, "observations": 0,
                  "tracks": 0, "inlier_reproj_px": 0.0135, "outlier_fraction": 1e-4,
                  "k1": 1e-4}
SFM_ATE_CEILING_MM = 0.5

# The CLI (phases 4g-6g). The key set of every JSON line a subcommand prints,
# as the JAX package's CLI prints it for the same run (depth with ground truth
# found, calibrate with --estimate-distortion, evaluate at its default taus,
# inspect of depth.npz); tests/test_torch_cli_parity.py holds these to the
# reference.
CLI_KEYS = {
    "render": ("output", "rendered", "resolution"),
    "depth": ("bad_2pct_depth", "mean_abs_err", "median_rel_err", "output", "points",
              "valid_fraction"),
    "reconstruct": ("bad_2pct_depth", "mean_support", "median_rel_err", "output", "points",
                    "raw_points", "views"),
    "two-view": ("mean_confidence", "output", "valid_fraction"),
    "calibrate": ("inlier_reproj_px", "inlier_threshold_px", "k1", "k2", "mean_reproj_px",
                  "num_obs", "outlier_fraction", "output"),
    "serve": ("frames", "frames_per_s", "output", "wall_s"),
    "evaluate": ("bad_0.5", "bad_1.0", "bad_2.0", "epe", "gt_key", "key", "masked_mean_err",
                 "valid_fraction"),
    "inspect": ("__meta__", "confidence", "depth", "disparity", "valid"),
}
# path (b): bench_array.py's CROSS config on the calibrated rig
CALIBRATED_DEPTH_CFG = {"camera.rows": 5, "camera.cols": 5, "plane_sweep.num_planes": 128,
                        "plane_sweep.topology": "CROSS"}
# the reference's kernel route on the JAX calibration of the record's scene, the
# 25 views undistorted with its (k1, k2), computed with JAX on the CPU by
# tests/test_torch_calibration.py::test_calibrated_depth_reference_recompute.
# A calibrated rig is the true one up to a similarity: BA pins the scale to the
# guess's camera-0 -> camera-1 baseline, 6% off here, so every depth is 6% off
# and none within 1% (the true rig's run is printed beside it). The port on the
# CPU lands 8.2e-6 (sweep) and 5.9e-5 (refined) from these values; the bounds
# are about 3x.
CALIBRATED_DEPTH = {"median_rel_depth_err_sweep": 0.06237900257110596,
                    "median_rel_depth_err_refined": 0.058177411556243896,
                    "frac_rel_err_lt_1pct_refined": 0.0, "density": 1.0}
CALIBRATED_DEPTH_TOL = {"median_rel_depth_err_sweep": 2.5e-5,
                        "median_rel_depth_err_refined": 1.8e-4,
                        "frac_rel_err_lt_1pct_refined": 0.0, "density": 0.0}


def record_misses(got: dict, want: dict, tol: dict) -> dict:
    """The metrics of `got` off `want` by more than `tol`: {name: (got, want)}."""
    return {m: (got[m], want[m]) for m in want if not abs(got[m] - want[m]) <= tol[m]}


def reference_scale_calibration(torch, device) -> dict:
    """Phase 5f's records on `device`: calibrate_array at the record's scale
    (path (a)), then path (b), the 25 lensed views undistorted with the
    estimated (k1, k2) through array_depth_pipeline on the calibrated rig, and
    the same pipeline on the true rig, each scored by array_depth_metrics
    against the reference view's exact depth."""
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.evaluation import (
        absolute_trajectory_error,
        array_depth_metrics,
    )
    from stereovisionarray_tpu_torch.geometry import (
        Distortion,
        camera_array_from_numpy,
        distort_image,
        undistort_image,
    )
    from stereovisionarray_tpu_torch.models import array_depth_pipeline, calibrate_array

    rows, cols, h, w = SFM_SHAPE
    rig = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(h, w))
    images, depths = render_camera_array(rig, (h, w))
    rig_dev = rig.to(device)
    lensed = distort_image(torch.from_numpy(images).to(device), rig_dev,
                           Distortion(k1=-0.2, k2=0.03))[0]
    host = rig.host()
    t_bad = host.t.copy()
    t_bad[1:] += np.random.default_rng(1).normal(0, 0.01, t_bad[1:].shape).astype(np.float32)
    init = camera_array_from_numpy(host.fx, host.fy, host.cx, host.cy, host.R, t_bad,
                                   device=device)
    cfg = EngineConfig().override(**CALIBRATED_DEPTH_CFG, **{"sfm.ba_iterations": 30})
    ref = (rows // 2) * cols + cols // 2
    cal = calibrate_array(lensed, init, ref, cfg.sfm, rounds=2, estimate_distortion=True)
    gt = torch.from_numpy(-np.einsum("nji,nj->ni", host.R, host.t))

    def ate_mm(cams):
        return float(absolute_trajectory_error(cams.centers.cpu(), gt, align_scale=True)) * 1e3

    k1, k2 = cal.distortion
    calibration = {"ate_mm_initial": ate_mm(init), "ate_mm_calibrated": ate_mm(cal.cameras),
                   "observations": int(cal.num_obs), "tracks": int(cal.point_valid.sum()),
                   "inlier_reproj_px": float(cal.inlier_reproj),
                   "outlier_fraction": float(cal.outlier_fraction), "k1": float(k1),
                   "k2": float(k2)}
    views = undistort_image(lensed, cal.cameras, Distortion(k1=k1, k2=k2))[0]
    out = {}
    for name, cams in (("depth", cal.cameras), ("true_rig_depth", rig_dev)):
        res = array_depth_pipeline(views, cams, cfg, ref_index=ref)
        out[name] = array_depth_metrics(res.depth, res.refined_depth, res.valid, depths[ref])
    return {"calibration": calibration, **out, "k": (k1, k2), "views": views,
            "cameras": cal.cameras, "lensed": lensed, "init": init, "cfg": cfg, "ref": ref,
            "rig": rig_dev}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi printed nothing")
    return out


def stereo_pair(torch, h, w, seed, offset=32, integer=False):
    """A rectified random pair as bench.py builds it: right = left shifted."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 255.0, size=(h, w + offset)).astype(np.float32)
    if integer:  # 8-bit frames: exact .5 ties in the scale-1 int8 costs
        base = np.floor(base)
    left = torch.from_numpy(np.ascontiguousarray(base[:, :w])).cuda()
    right = torch.from_numpy(np.ascontiguousarray(base[:, offset:])).cuda()
    return left, right


def max_err(torch, a, b) -> float:
    if a is None and b is None:  # a map both routes leave out
        return 0.0
    if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
        fail(f"outputs differ in kind: {a if a is None else (tuple(a.shape), a.dtype)} vs "
             f"{b if b is None else (tuple(b.shape), b.dtype)}")
    if torch.equal(a, b):
        return 0.0
    return (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()  # NaN if only NaNs differ


def device_ms(torch, fn, iters):
    """Device ms of one fn() from `iters` calls queued behind a GPU spin
    (``torch.cuda._sleep``), so that the two events bracket the device's work
    and none of the host's. The spin doubles until the host has enqueued
    every call before it ends; None if it never does."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()  # the spin still ran when the last call was enqueued
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 2
    return None


def cuda_ms(torch, fn, iters, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def roi_gate_mask(torch, image, mode):
    """The use_roi gate of array_depth_pipeline on one reference image."""
    from stereovisionarray_tpu_torch.roi import detect_face_ellipse, ellipse_mask, face_mask

    if mode == "face":
        return face_mask(image)
    roi = detect_face_ellipse(image)
    return ellipse_mask(tuple(image.shape), roi.center, roi.axes, roi.angle) | ~roi.found


def iou(a, b) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float((a & b).sum() / max((a | b).sum(), 1))


def served_scene(torch, tmp, device="cuda"):
    """SERVED_SETS frame-sets of the bench_array rig (four textures, each
    twice) written as PNGs under `tmp`, one directory a set: (CUDA rig, its
    config, the set directories, the temporal settings)."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.datasets import save_png
    from stereovisionarray_tpu_torch.datasets.synthetic import (
        SceneSpec,
        reference_rig,
        render_camera_array,
    )
    from stereovisionarray_tpu_torch.models import (
        TemporalParams,
        array_baselines,
        reference_and_sources,
    )

    rows, cols, h, w, planes = ARRAY_SHAPE
    cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(h, w))
    cfg = config.EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                            "plane_sweep.num_planes": planes,
                                            "plane_sweep.topology": "CROSS"})
    dirs = []
    for i in range(SERVED_SETS):
        if i % 2 == 0:
            views = render_camera_array(cams, (h, w), SceneSpec(texture_seed=i // 2))[0]
        d = Path(tmp) / f"set_{i:02d}"
        d.mkdir()
        for j, img in enumerate(views):
            save_png(str(d / f"view_{j:02d}.png"), img, vmin=0.0, vmax=255.0)
        dirs.append(str(d))
    ref, src = reference_and_sources(cfg, rows * cols)
    params = TemporalParams(baseline=array_baselines(cams, ref, src)[1],
                            focal_px=float(cams.host().fx[ref]), max_diff=1.5)
    return cams.to(device), cfg, dirs, params


def served_path(torch, counted, tag, cams, cfg, dirs, params) -> dict:
    """Phase 4e: the served path on the card, every output against direct
    pipeline calls and the port's filter; the wrappers' launch counts."""
    from stereovisionarray_tpu_torch.datasets import native_available
    from stereovisionarray_tpu_torch.models import (
        array_depth_pipeline,
        frame_sets_from_dirs,
        stream_depth_maps,
        stream_depth_maps_chunked,
        temporal_init,
        temporal_update,
    )
    from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth

    device = cams.fx.device
    decoder = "native_loader (C++ codec)" if native_available() else "io.read_png (zlib)"
    stacks = list(frame_sets_from_dirs(dirs))
    emit({"phase": "served_path", "run": "decode", "decoder": decoder, "sets": len(stacks),
          "shape": list(stacks[0].shape), "dtype": str(stacks[0].dtype), **tag})

    def serve():
        served = list(stream_depth_maps(iter(stacks), cams, cfg, depth=2, device=device))
        chunked = list(stream_depth_maps_chunked(iter(stacks), cams, cfg, depth=2, chunk=4,
                                                 temporal=params, device=device))
        return served, chunked

    (served, chunked), launches, entries = counted(serve)
    needed = ["K8 plane_sweep", "K2/K3 sgm_paths", "K4 extract_maps"]
    missing = [n for n in needed if launches[n] == 0]
    if missing:
        fail(f"the served path never launched {missing}")
    direct = [array_depth_pipeline(torch.from_numpy(st).to(device), cams, cfg) for st in stacks]
    state, filtered = temporal_init(tuple(direct[0].refined_disparity.shape), device), []
    for out in direct:
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence, max_diff=params.max_diff,
                                      max_weight=params.max_weight,
                                      max_hole_age=params.max_hole_age)
        filtered.append((tout, torch.where(tout.valid, disparity_to_depth(
            tout.disparity, params.baseline, params.focal_px), 0.0)))
    fields = ("depth", "refined_depth", "disparity", "refined_disparity", "valid", "mask")
    sweep_fields = ("depth", "plane", "cost", "valid", "num_views", "confidence")
    errs = collections.defaultdict(float)

    def note(name, a, b):
        errs[name] = max(errs[name], max_err(torch, a, b))

    if [r.index for r in served] != list(range(len(stacks))) or [
            r.index for r in chunked] != list(range(len(stacks))):
        fail("the served path's results are out of order or missing")
    for run, results in (("served", served), ("chunked", chunked)):
        for r, want in zip(results, direct):
            for f in fields:
                note(f"{run}.{f}", getattr(r.output, f), getattr(want, f))
            for f in sweep_fields:
                note(f"{run}.sweep.{f}", getattr(r.output.sweep, f), getattr(want.sweep, f))
    for r, (tout, depth) in zip(chunked, filtered):
        for f in ("disparity", "valid", "stability", "coasted"):
            note(f"chunked.temporal.{f}", getattr(r.temporal, f), getattr(tout, f))
        note("chunked.temporal.depth", r.depth, depth)
    plain = array_depth_pipeline(torch.from_numpy(stacks[0]).to(device), cams, cfg, backend="torch")
    for f in fields:
        note(f"set0_vs_plain.{f}", getattr(direct[0], f), getattr(plain, f))
    finite = all(bool(torch.isfinite(r.output.refined_depth).all()) for r in served)
    emit({"phase": "served_path", "run": "stream", "shape": [*stacks[0].shape, cfg.plane_sweep.num_planes],
          "depth": 2, "chunk": 4, "cameras_on": str(cams.fx.device),
          "valid_fraction": [round(r.output.valid.float().mean().item(), 6) for r in served],
          "stability_mean": [round(r.temporal.stability.mean().item(), 6) for r in chunked],
          "launches": {n: c for n, c in launches.items() if c}, "entry_launches": entries,
          "max_abs_err_vs_direct": dict(errs), "finite": finite, **tag})
    if any(e != 0.0 for e in errs.values()) or not finite:
        fail("the served path differs from direct calls or the plain path, or is not finite")

    # the use_roi gate, both modes, on a served set and on one whose reference
    # view is a head scene (the landmark branch of roi.face_mask)
    from stereovisionarray_tpu_torch.models import reference_and_sources
    from stereovisionarray_tpu_torch.roi import detect_face

    ref = reference_and_sources(cfg, len(stacks[0]))[0]
    head = stacks[0].copy()
    h, w = head.shape[1:]
    head[ref] = render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h, fw=0.25 * w,
                            rng=np.random.default_rng(0))[0]
    for scene, imgs in (("served_set", stacks[0]), ("head_reference", head)):
        for mode in ("face", "otsu"):
            x = torch.from_numpy(imgs).to(device)
            out = array_depth_pipeline(x, cams, cfg, use_roi=True, roi_mode=mode)
            want = roi_gate_mask(torch, torch.from_numpy(imgs[ref]), mode)
            got_iou = iou(out.mask, want)
            line = {"phase": "served_path", "run": f"use_roi_{mode}", "scene": scene,
                    "mask_fraction": out.mask.float().mean().item(), "iou_vs_cpu_mask": got_iou,
                    "valid_outside_mask": int((out.valid & ~out.mask).sum()), **tag}
            if mode == "face":
                line["face_found"] = bool(detect_face(x[ref]).found)
            emit(line)
            if got_iou < 0.99 or line["valid_outside_mask"]:
                fail(f"use_roi={mode} on {scene}: mask IoU {got_iou} against the CPU's")
            if scene == "head_reference" and mode == "face" and not line["face_found"]:
                fail("the face detector missed the head scene on the card")
    return launches


def records(torch, tag, device="cuda") -> None:
    """Phase 5e: the face, temporal and fusion accuracy records of the JAX
    package's EVAL files, each against its stated tolerance."""
    for name, file, fn, want, tol in (
            ("face", "EVAL_ROBUST_r05.json", face_record, FACE_RECORD, FACE_RECORD_TOL),
            ("temporal", "EVAL_TEMPORAL_r05.json", temporal_record, TEMPORAL_RECORD,
             TEMPORAL_RECORD_TOL),
            ("fusion", "EVAL_FUSION_r04.json", fusion_record, FUSION_RECORD, FUSION_RECORD_TOL)):
        got = fn(torch, device)
        off = {m: got[m] - want[m] for m in want if abs(got[m] - want[m]) > tol[m]}
        emit({"phase": "record", "record": name, "file": file, "metrics": got, "reference": want,
              "tolerance": tol, **tag})
        if off:
            fail(f"the {name} record is off by {off}")
        if name == "temporal" and not got["filtered_epe"] < got["per_frame_epe"]:
            fail(f"the temporal filter did not lower the EPE: {got}")


def served_timing(torch, tag, cams, cfg, dirs, params) -> None:
    """Phase 6e: the served loop against a serial loop, the chunked loop, and
    the new stages' times, with CUDA events or a host clock that ends in a
    synchronize."""
    from stereovisionarray_tpu_torch.datasets import load_image_stack, native_available
    from stereovisionarray_tpu_torch.datasets.io import list_images_sorted
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.models import (
        array_depth_pipeline,
        fuse_depth_maps,
        reconstruct_array,
        serving,
        stream_depth_maps,
        stream_depth_maps_chunked,
        temporal_init,
        temporal_update,
    )
    from stereovisionarray_tpu_torch.parallel import to_device
    from stereovisionarray_tpu_torch.roi import face_mask

    device = cams.fx.device
    paths = [list_images_sorted(d) for d in dirs]
    decode_s, step_s, done = [], [], []

    def decoded():
        for p in paths:
            t0 = time.perf_counter()
            stack = load_image_stack(p)
            decode_s.append(time.perf_counter() - t0)
            yield stack

    real_pipeline = serving.array_depth_pipeline

    def timed_pipeline(*args, **kw):  # host time inside each call; an event after it
        t0 = time.perf_counter()
        out = real_pipeline(*args, **kw)
        step_s.append(time.perf_counter() - t0)
        done.append(torch.cuda.Event())
        done[-1].record()
        return out

    def serial():
        for stack in decoded():
            array_depth_pipeline(to_device(stack, device), cams, cfg)
            torch.cuda.synchronize()

    # the consumer waits for each set's own work (the event after its
    # pipeline call), not for the set enqueued after it
    def served():
        for r in stream_depth_maps(decoded(), cams, cfg, depth=2, device=device):
            done[r.index].synchronize()

    def chunked():
        for r in stream_depth_maps_chunked(decoded(), cams, cfg, depth=2, chunk=4,
                                           temporal=params, device=device):
            done[r.index].synchronize()

    rows, cols, h, w, _ = ARRAY_SHAPE
    serial()  # warm: kernels, pinned staging
    for name, run in (("serial", serial), ("served", served), ("served", served),
                      ("serial", serial), ("chunked_temporal", chunked)):
        decode_s.clear()
        step_s.clear()
        done.clear()
        serving.array_depth_pipeline = timed_pipeline
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()  # the last set's filter, where there is one
            wall = time.perf_counter() - t0
        finally:
            serving.array_depth_pipeline = real_pipeline
        emit({"phase": "timing", "metric": "served_frame_sets_per_s", "run": name,
              "shape": [len(paths[0]), h, w, cfg.plane_sweep.num_planes], "sets": len(paths),
              "decoder": "native" if native_available() else "read_png",
              "frame_sets_per_s": len(paths) / wall, "ms_per_frame_set": wall / len(paths) * 1e3,
              "decode_ms_per_set": 1e3 * sum(decode_s) / len(paths),
              "decode_share": sum(decode_s) / wall,
              "host_ms_in_pipeline_per_set": (1e3 * sum(step_s) / len(step_s)) if step_s else None,
              **tag})

    rng = np.random.default_rng(11)
    d = torch.from_numpy(rng.uniform(1, 60, (h, w)).astype(np.float32)).to(device)
    v = torch.from_numpy(rng.uniform(size=(h, w)) > 0.2).to(device)
    c = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(device)
    state = temporal_update(temporal_init((h, w), device), d, v, c)[0]
    head = torch.from_numpy(render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h, fw=0.25 * w,
                                        rng=np.random.default_rng(0))[0]).to(device)
    fcams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(135, 180))
    fimages, fdepths = render_camera_array(fcams, (135, 180))
    fcams, fimages = fcams.to(device), torch.from_numpy(fimages).to(device)
    fdepths = torch.from_numpy(fdepths).to(device)
    for name, shape, fn, iters in (
            ("temporal_update", [h, w], lambda: temporal_update(state, d, v, c), TIMED_FRAMES),
            ("face_mask", [h, w], lambda: face_mask(head), ARRAY_FRAMES),
            ("fuse_depth_maps", [25, 135, 180], lambda: fuse_depth_maps(fcams, fdepths), 3),
            ("reconstruct_array", [25, 135, 180, 96],
             lambda: reconstruct_array(fimages, fcams, fusion_config()), 1)):
        ms = cuda_ms(torch, fn, iters, warmup=1)
        # one call queued behind a spin: more would fill the device's launch
        # queue and block the host (fusion's ~2,000 launches a call do alone)
        dev = device_ms(torch, fn, 1) if name in ("temporal_update", "face_mask") else None
        emit({"phase": "timing", "metric": f"{name}_ms", "shape": shape, "iters": iters,
              "ms": ms, "device_ms": dev, **tag})


VERGED_SHAPE = (540, 768, 64)  # path (c): bench.py's frame and disparities
VERGED_BASELINE = 0.045  # m: rectified disparities 48-57 px on the scene (fit in 64)


def verged_pair(torch, device):
    """Path (c)'s scene: two cameras of the reference rig's focal length
    (f = 0.05 m, 36 mm sensor) 0.045 m apart at z = -0.75, each turned toward
    (0, 0, 0.25) (1.3 degrees of vergence), rendering SceneSpec() at
    540x768. Returns (rig on `device`, left, right, left view's exact depth)."""
    from stereovisionarray_tpu_torch.datasets.synthetic import SceneSpec, render_view
    from stereovisionarray_tpu_torch.geometry import camera_array_from_numpy, look_at_rotation

    h, w, _ = VERGED_SHAPE
    f = 0.05 / (0.036 / w)
    eyes = np.array([[-VERGED_BASELINE / 2, 0.0, -0.75], [VERGED_BASELINE / 2, 0.0, -0.75]])
    R = np.stack([look_at_rotation(e, (0.0, 0.0, 0.25)).numpy() for e in eyes])
    t = np.einsum("nij,nj->ni", R, -eyes).astype(np.float32)
    cams = camera_array_from_numpy(np.full(2, f), np.full(2, f), np.full(2, w / 2.0),
                                   np.full(2, h / 2.0), R, t, device=device)
    (left, depth), (right, _) = (render_view(cams, i, (h, w), SceneSpec()) for i in (0, 1))
    return cams, torch.from_numpy(left).to(device), torch.from_numpy(right).to(device), depth


def rectified_frame(rect, left, right, cfg, backend="auto"):
    """One frame of a rectified pair: both warps, two-view SGM, metric depth."""
    from stereovisionarray_tpu_torch.geometry import rectified_disparity_to_depth, rectify_images
    from stereovisionarray_tpu_torch.models.two_view import two_view_disparity

    lw, lv, rw, _ = rectify_images(left, right, rect)
    out = two_view_disparity(lw, rw, *cfg, backend=backend)
    return out, rectified_disparity_to_depth(out.disparity, rect), lv, rect


def rectified_two_view(cams, left, right, cfg, backend="auto"):
    """Path (c): rectify the verged pair (rectify_pair), then one frame."""
    from stereovisionarray_tpu_torch.geometry import rectify_pair

    return rectified_frame(rectify_pair(cams, 0, 1), left, right, cfg, backend)


def rectified_depth_error(depth, valid, rect, cams, gt_depth) -> dict:
    """Path (c)'s accuracy: each rectified pixel's depth against the exact
    depth of the left view's point it maps to (nearest pixel), along the
    rectified z axis, over the valid pixels right of the disparity range."""
    h, w, D = VERGED_SHAPE
    H = rect.H_left.cpu().double().numpy()
    v, u = np.mgrid[0:h, 0:w]
    p = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3) @ H.T
    src = p[:, :2] / p[:, 2:3]
    z_old = gt_depth[np.clip(np.round(src[:, 1]).astype(int), 0, h - 1),
                     np.clip(np.round(src[:, 0]).astype(int), 0, w - 1)]
    host = cams.host()
    K_inv = np.linalg.inv(np.array([[host.fx[0], 0, host.cx[0]], [0, host.fy[0], host.cy[0]],
                                    [0, 0, 1]], np.float64))
    X = (np.concatenate([src, np.ones((len(src), 1))], 1) @ K_inv.T) * z_old[:, None]
    z_rect = (X @ (rect.R_new.cpu().double().numpy() @ host.R[0].T.astype(np.float64)).T)[:, 2]
    sel = valid.copy()
    sel[:, :D + 8] = False
    rel = np.abs(depth - z_rect.reshape(h, w))[sel] / z_rect.reshape(h, w)[sel]
    return {"scored_fraction": float(sel.mean()), "median_rel_depth_err": float(np.median(rel)),
            "frac_rel_err_lt_1pct": float((rel < 0.01).mean())}


def device_events(torch, fn) -> tuple:
    """(device events, device busy ms) of one fn() under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(cuda), sum(e.time_range.elapsed_us() for e in cuda) / 1e3


def calibration_paths(torch, counted, tag, bench_cfg) -> tuple:
    """Phase 4f: path (a) once, then paths (b) and (c) counted, each output
    bit-exact to backend="torch" on the card. Returns (state, launches)."""
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    t0 = time.perf_counter()
    state = reference_scale_calibration(torch, "cuda")
    state["first_run_s"] = time.perf_counter() - t0
    cams, views, cfg, ref = state["cameras"], state["views"], state["cfg"], state["ref"]
    if cams.host_fields is None or not cams.fx.is_cuda:
        fail("calibrate_array's cameras do not carry their host copy, or left the card")
    launches = collections.Counter()
    errs = {}
    (out_b, counts_b, entries_b) = counted(
        lambda: array_depth_pipeline(views, cams, cfg, ref_index=ref))
    plain_b = array_depth_pipeline(views, cams, cfg, ref_index=ref, backend="torch")
    for f in ("depth", "refined_depth", "disparity", "refined_disparity", "valid"):
        errs[f"b.{f}"] = max_err(torch, getattr(out_b, f), getattr(plain_b, f))
    for f in ("plane", "cost", "num_views", "confidence"):
        errs[f"b.sweep.{f}"] = max_err(torch, getattr(out_b.sweep, f), getattr(plain_b.sweep, f))
    need_b = ["K2/K3 sgm_paths", "K4 extract_maps"]
    if any(counts_b[n] == 0 for n in need_b) or counts_b["K8 plane_sweep"]:
        fail(f"path (b) launched {dict(counts_b)}: want K2/K3 and K4, and no K8 (general rig)")
    launches.update(counts_b)
    emit({"phase": "calibrated_path", "run": "b_calibrated_depth",
          "shape": [*views.shape, cfg.plane_sweep.num_planes],
          "route": "homography chain (general rig)",
          "rotation_off_identity": float((cams.R - torch.eye(3, device=cams.R.device))
                                         .abs().max()),
          "valid_fraction": out_b.valid.float().mean().item(),
          "launches": {n: c for n, c in counts_b.items() if c}, "entry_launches": entries_b,
          "max_abs_err_vs_plain": {k: v for k, v in errs.items() if k.startswith("b.")},
          "finite": bool(torch.isfinite(out_b.refined_depth).all()), **tag})

    vcams, left, right, gt = verged_pair(torch, "cuda")
    (out_c, counts_c, entries_c) = counted(
        lambda: rectified_two_view(vcams, left, right, bench_cfg))
    plain_c = rectified_two_view(vcams, left, right, bench_cfg, backend="torch")
    for f in ("disparity", "valid", "cost", "confidence"):
        errs[f"c.{f}"] = max_err(torch, getattr(out_c[0], f), getattr(plain_c[0], f))
    errs["c.depth"] = max_err(torch, out_c[1], plain_c[1])
    need_c = ["K1 cost_volume", "K2/K3 sgm_paths", "K4 extract_maps", "K5 lr_check fused"]
    if any(counts_c[n] == 0 for n in need_c):
        fail(f"path (c) never launched {[n for n in need_c if counts_c[n] == 0]}")
    launches.update(counts_c)
    valid_c = (out_c[0].valid & out_c[2] & (out_c[1] > 0)).cpu().numpy()
    acc = rectified_depth_error(out_c[1].cpu().numpy(), valid_c, out_c[3], vcams, gt)
    d = out_c[0].disparity[out_c[0].valid]
    emit({"phase": "calibrated_path", "run": "c_rectified_two_view", "shape": list(VERGED_SHAPE),
          "disparity_p1_p99": [float(torch.quantile(d, q)) for q in (0.01, 0.99)],
          "valid_fraction": out_c[0].valid.float().mean().item(), "accuracy": acc,
          "launches": {n: c for n, c in counts_c.items() if c}, "entry_launches": entries_c,
          "max_abs_err_vs_plain": {k: v for k, v in errs.items() if k.startswith("c.")}, **tag})
    if any(e != 0.0 for e in errs.values()):
        fail(f"paths (b) / (c) differ from backend='torch': {errs}")
    if not (acc["median_rel_depth_err"] < 0.01 and acc["scored_fraction"] > 0.5):
        fail(f"path (c)'s rectified depth is off: {acc}")
    state.update(verged=(vcams, left, right))
    return state, launches


def calibration_records(tag, state) -> None:
    """Phase 5f: EVAL_SFM_r05.json's reference-scale row and the calibrated
    depth record, each against its bounds; the true rig's depth beside it."""
    got = state["calibration"]
    emit({"phase": "record", "record": "sfm_reference_scale", "file": "EVAL_SFM_r05.json",
          "metrics": got, "reference": SFM_RECORD, "tolerance": SFM_RECORD_TOL,
          "first_run_s": state["first_run_s"], **tag})
    misses = record_misses(got, SFM_RECORD, SFM_RECORD_TOL)
    if misses or not got["ate_mm_calibrated"] < SFM_ATE_CEILING_MM:
        fail(f"the reference-scale calibration is off the record: {misses or got}")
    emit({"phase": "record", "record": "calibrated_depth", "metrics": state["depth"],
          "reference": CALIBRATED_DEPTH, "tolerance": CALIBRATED_DEPTH_TOL,
          "true_rig_same_views": state["true_rig_depth"], **tag})
    misses = record_misses(state["depth"], CALIBRATED_DEPTH, CALIBRATED_DEPTH_TOL)
    if misses:
        fail(f"path (b)'s depth is off its record: {misses}")


def calibration_timing(torch, tag, state, bench_cfg, bench_pair) -> None:
    """Phase 6f: calibrate_array's wall and device time, device events and
    busy share, the time of its stages (events recorded between them); two
    runs bit-identical; the 25-view undistortion; path (b) per frame-set
    beside the true rig's translation route (K8); path (c) per frame beside
    the plain two-view frame."""
    from stereovisionarray_tpu_torch.geometry import Distortion, rectify_pair, undistort_image
    from stereovisionarray_tpu_torch.models import array_depth_pipeline, calibration
    from stereovisionarray_tpu_torch.models.two_view import two_view_disparity

    lensed, init, cfg, ref = state["lensed"], state["init"], state["cfg"], state["ref"]

    def calibrate():
        return calibration.calibrate_array(lensed, init, ref, cfg.sfm, rounds=2,
                                           estimate_distortion=True)

    # the stages, bracketed by events on the stream: build_tracks, the
    # distortion solve, each round's triangulation + BA
    marks, real = [], {n: getattr(calibration, n) for n in (
        "build_tracks", "_radial_from_vertical_parallax", "triangulate_midpoint", "bundle_adjust")}

    def marked(name, fn):
        def run(*a, **kw):
            for suffix in ("", ".end"):
                if suffix:
                    out = fn(*a, **kw)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name + suffix, ev))
            return out
        return run

    def pick(name):
        return [ev for n, ev in marks if n == name]

    runs = []
    for i in range(3):
        marks.clear()
        for n, fn in real.items():
            setattr(calibration, n, marked(n, fn))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = calibrate()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            for n, fn in real.items():
                setattr(calibration, n, fn)
        spans = {"build_tracks_ms": pick("build_tracks")[0].elapsed_time(
                     pick("build_tracks.end")[0]),
                 "distortion_solve_ms": pick("_radial_from_vertical_parallax")[0].elapsed_time(
                     pick("_radial_from_vertical_parallax.end")[0])}
        for r, (a, b) in enumerate(zip(pick("triangulate_midpoint"), pick("bundle_adjust.end"))):
            spans[f"round{r + 1}_triangulate_ba_ms"] = a.elapsed_time(b)
        runs.append(out)
        emit({"phase": "timing", "metric": "calibrate_array_ms", "run": i,
              "shape": [*lensed.shape], "wall_ms": wall, "device_span_ms": start.elapsed_time(end),
              **spans, **tag})
    first = runs[0]
    same = all(torch.equal(a, b) for r in runs[1:] for a, b in (
        (r.cameras.R, first.cameras.R), (r.cameras.t, first.cameras.t), (r.points, first.points),
        (r.cost, first.cost), (r.distortion[0], first.distortion[0])))
    events, busy_ms = device_events(torch, calibrate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    emit({"phase": "timing", "metric": "calibrate_array_device_events", "device_events": events,
          "device_busy_ms": busy_ms, "wall_ms": wall, "busy_share": busy_ms / wall,
          "runs_bit_identical": same, **tag})
    if not same:
        fail("two calibrate_array runs on the card differ")

    k = state["k"]
    cams, views, rig = state["cameras"], state["views"], state["rig"]
    for name, fn, iters in (
            ("undistort_25_views", lambda: undistort_image(lensed, cams, Distortion(*k)), 20),
            ("b_calibrated_depth_per_frame_set",
             lambda: array_depth_pipeline(views, cams, cfg, ref_index=ref), 3),
            ("true_rig_translation_route_per_frame_set",
             lambda: array_depth_pipeline(views, rig, cfg, ref_index=ref), 5)):
        emit({"phase": "timing", "metric": f"{name}_ms", "iters": iters,
              "ms": cuda_ms(torch, fn, iters, warmup=1), **tag})
    vcams, left, right = state["verged"]
    rect = rectify_pair(vcams, 0, 1)  # once per rig
    for name, fn in (("c_rectified_two_view_per_frame",
                      lambda: rectified_two_view(vcams, left, right, bench_cfg)),
                     ("c_rectified_frame_rectification_once",
                      lambda: rectified_frame(rect, left, right, bench_cfg)),
                     ("plain_two_view_per_frame", lambda: two_view_disparity(*bench_pair,
                                                                             *bench_cfg))):
        emit({"phase": "timing", "metric": f"{name}_ms", "shape": list(VERGED_SHAPE),
              "iters": TIMED_FRAMES, "ms": cuda_ms(torch, fn, TIMED_FRAMES), **tag})


# ---------------------------------------------------------------------------
# The CLI (phases 4g-6g): cli.main(argv) in-process, each artifact against the
# port's functions called directly on the images the CLI decoded
CLI_ARRAY = ["--set", "plane_sweep.topology=CROSS"]  # bench_array.py: 5x5, 270x360, 128 planes
# phase 5's fixture: D=64, census 7x9, p1 8, p2 96, 8 paths, adaptive P2,
# uniqueness 0.95 (the defaults) and LR 1.5
CLI_FIXTURE = ["--set", "cost.num_disparities=64", "--set", "sgm.lr_max_diff=1.5"]
CLI_BENCH = ["--set", f"cost.num_disparities={BENCH_SHAPE[2]}", "--set", "cost.dtype=int8"]
# scripts/perf_cascade.py's configuration (two_view_cascade_config)
CLI_CASCADE = ["--set", f"cost.num_disparities={CASCADE_SHAPE[2]}", "--set", "cost.dtype=int8",
               "--cascade", "--coarse-factor", "4", "--fine-disparities", "24",
               "--band-step", "8"]
ARRAY_PATH = ["K8 plane_sweep", "K2/K3 sgm_paths", "K4 extract_maps"]
TWO_VIEW_PATH = ["K1 cost_volume", "K2/K3 sgm_paths", "K4 extract_maps", "K5 lr_check fused"]


def cli_config(argv):
    """The EngineConfig a CLI command line resolves to."""
    from stereovisionarray_tpu_torch import cli

    return cli.load_config(cli.build_parser().parse_args(argv))


def cli_run(torch, counted, argv) -> dict:
    """cli.main(argv) in-process with every launch count set to 0 just
    before: its printed JSON line, the wrappers' counts, the C entry points,
    and the host wall and CUDA-event ms of the call."""
    import contextlib
    import io

    from stereovisionarray_tpu_torch import cli

    buf = io.StringIO()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        end.record()
        return rc

    t0 = time.perf_counter()
    rc, launches, entries = counted(run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        fail(f"cli {argv[0]} returned {rc}")
    text = buf.getvalue().strip()
    return {"json": json.loads(text.splitlines()[-1]), "launches": launches, "entries": entries,
            "wall_ms": wall_ms, "events_ms": start.elapsed_time(end)}


class ArtifactCheck:
    """Each artifact of a CLI run against the same artifact made from the
    port's direct outputs: max |difference| per array, PNG and PLY (0: equal)."""

    def __init__(self, torch, scratch: Path):
        self.torch, self.scratch, self.errs = torch, scratch, {}

    def _note(self, name, err):
        self.errs[name] = max(self.errs.get(name, 0.0), err)

    def arrays(self, path, want: dict, tag=""):
        from stereovisionarray_tpu_torch.datasets import load_array

        got, _ = load_array(str(path))
        if sorted(got) != sorted(want):
            fail(f"{path} holds {sorted(got)}, not {sorted(want)}")
        for k, v in want.items():
            v = v.detach().cpu().numpy() if self.torch.is_tensor(v) else np.asarray(v)
            g = got[k]
            if g.dtype != v.dtype or g.shape != v.shape:
                fail(f"{path}[{k}] is {g.dtype} {g.shape}, not {v.dtype} {v.shape}")
            same = np.array_equal(g, v, equal_nan=bool(np.issubdtype(v.dtype, np.floating)))
            self._note(f"{tag}{Path(path).name}:{k}", 0.0 if same else float(
                np.nanmax(np.abs(g.astype(np.float64) - v.astype(np.float64)))))

    def png(self, path, array, tag="", **kw):
        from stereovisionarray_tpu_torch.datasets import read_png, save_png

        a = array.detach().cpu().numpy() if self.torch.is_tensor(array) else array
        want = self.scratch / "want.png"
        save_png(str(want), a, **kw)
        g, w = read_png(str(path)).astype(np.int32), read_png(str(want)).astype(np.int32)
        self._note(f"{tag}{Path(path).name}", float(np.abs(g - w).max()) if g.shape == w.shape
                   else float("inf"))

    def ply(self, path, *args, tag="", **kw):
        from stereovisionarray_tpu_torch.datasets import save_ply

        want = self.scratch / "want.ply"
        n = save_ply(str(want), *args, **kw)
        self._note(f"{tag}{Path(path).name}", 0.0 if Path(path).read_bytes() == want.read_bytes()
                   else 1.0)
        return n

    def value(self, name, got, want):
        self._note(name, 0.0 if got == want else abs(float(got) - float(want)))

    def same(self, name, ok: bool):
        self._note(name, 0.0 if ok else 1.0)


def cli_depth_direct(torch, images, cams, cfg, backend="torch"):
    """What `depth` computes, called directly: (pipeline output, points,
    point validity, colors) of the grid centre."""
    from stereovisionarray_tpu_torch.geometry import depth_map_to_points, point_cloud_colors
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    out = array_depth_pipeline(images, cams, cfg, backend=backend)
    ref = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
    pts, pvalid = depth_map_to_points(cams[ref], out.refined_depth, mask=out.valid)
    return out, pts, pvalid, point_cloud_colors(images[ref], pvalid), ref


def cli_paths(torch, counted, tag, scratch: Path, served_dirs) -> dict:
    """Phase 4g: every subcommand through cli.main on the card, each
    artifact bit-exact to the port's direct calls with backend="torch", each
    printed key set CLI_KEYS'; 5g: the fixture's `evaluate` against GOLDEN.
    Returns the state the timing phase reuses."""
    from stereovisionarray_tpu_torch import cli
    from stereovisionarray_tpu_torch.datasets import (
        list_images_sorted,
        load_array,
        load_image_gray,
        load_image_stack,
        read_pfm,
        save_array,
        write_png,
    )
    from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair
    from stereovisionarray_tpu_torch.evaluation import (
        bad_pixel_ratio,
        end_point_error,
        masked_mean_error,
    )
    from stereovisionarray_tpu_torch.models import (
        array_baselines,
        array_depth_pipeline,
        calibrate_array,
        cascade_two_view_disparity,
        reference_and_sources,
        temporal_init,
        temporal_update,
        two_view_disparity,
    )
    from stereovisionarray_tpu_torch.models.fusion import (
        depth_normals,
        fused_point_cloud,
        reconstruct_array,
    )
    from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth

    check = ArtifactCheck(torch, scratch)
    runs, totals = {}, collections.Counter()

    def run(name, argv, needed=()):
        r = cli_run(torch, counted, argv)
        runs[name] = r
        totals.update(r["launches"])
        command = argv[0]
        if command in CLI_KEYS and sorted(r["json"]) != sorted(CLI_KEYS[command]):
            fail(f"cli {name} printed keys {sorted(r['json'])}, not {sorted(CLI_KEYS[command])}")
        missing = [n for n in needed if r["launches"][n] == 0]
        if missing:
            fail(f"cli {name} never launched {missing}")
        return r

    # 1. render the default 5x5 rig at 270x360
    data = scratch / "data"
    run("render", ["render", "--output", str(data)])
    paths = list_images_sorted(str(data))
    images = torch.from_numpy(load_image_stack(paths)).to("cuda")
    h, w = images.shape[1:]
    gt_depths = load_array(str(data / "ground_truth.npz"))[0]["depths"]

    # 2. depth: CROSS, to_center, the CROSS cascade
    for name, extra, needed in (("depth_cross", CLI_ARRAY, ARRAY_PATH),
                                ("depth_to_center", [], ARRAY_PATH),
                                ("depth_cascade", [*CLI_ARRAY, "--cascade"],
                                 [*ARRAY_PATH, "K9 hat_sample_2d"])):
        out_dir = scratch / name
        r = run(name, ["depth", "--input", str(data), "--output", str(out_dir), *extra], needed)
        cfg = cli_config(["depth", "--input", ".", *extra])
        if "--cascade" in extra:
            cfg = cfg.override(**{"plane_sweep.cascade": True})
        cams = cli._rig_from_config(cfg, (h, w)).to("cuda")
        out, pts, pvalid, col, ref = cli_depth_direct(torch, images, cams, cfg)
        check.arrays(out_dir / "depth.npz", {
            "depth": out.refined_depth, "disparity": out.refined_disparity, "valid": out.valid,
            "confidence": out.sweep.confidence}, f"{name}/")
        check.png(out_dir / "depth.png", out.refined_depth, f"{name}/")
        check.png(out_dir / "disparity.png", out.refined_disparity, f"{name}/")
        n = check.ply(out_dir / "cloud.ply", pts.cpu().numpy().reshape(-1, 3),
                      colors=col.cpu().numpy(), valid=pvalid.cpu().numpy().reshape(-1),
                      tag=f"{name}/")
        gt = gt_depths[ref]
        d = out.refined_depth.cpu().numpy()
        mask = out.valid.cpu().numpy() & (gt > 0)
        check.png(out_dir / "error.png", np.abs(d - gt) * mask, f"{name}/")
        check.value(f"{name}/points", r["json"]["points"], n)
        check.value(f"{name}/mean_abs_err", r["json"]["mean_abs_err"], float(masked_mean_error(
            torch.from_numpy(d), torch.from_numpy(gt), torch.from_numpy(mask))))

    # 3-4. two-view: the fixture (int16, int8), a bench-shaped pair (int8), the cascade
    fixture = REPO / "data" / "eval_scene"
    pair_dir = scratch / "pairs"
    pair_dir.mkdir()
    bench_l, bench_r = stereo_pair(torch, BENCH_SHAPE[0], BENCH_SHAPE[1], seed=0, integer=True)
    casc_l, casc_r, _, _ = two_view_cascade_scene(torch, "cpu")
    for stem, a in (("bench_l", bench_l), ("bench_r", bench_r), ("cascade_l", casc_l),
                    ("cascade_r", casc_r)):
        write_png(str(pair_dir / f"{stem}.png"),
                  np.clip(np.round(a.cpu().numpy()), 0, 255).astype(np.uint8))
    two_views = (
        ("two_view_fixture_int16", fixture / "im0.png", fixture / "im1.png", CLI_FIXTURE, False),
        ("two_view_fixture_int8", fixture / "im0.png", fixture / "im1.png",
         [*CLI_FIXTURE, "--set", "cost.dtype=int8"], False),
        ("two_view_bench_int8", pair_dir / "bench_l.png", pair_dir / "bench_r.png", CLI_BENCH,
         False),
        ("two_view_cascade", pair_dir / "cascade_l.png", pair_dir / "cascade_r.png", CLI_CASCADE,
         True),
    )
    for name, lp, rp, extra, cascade in two_views:
        out_dir = scratch / name
        needed = [*TWO_VIEW_PATH[:3], "K9 hat_sample"] if cascade else TWO_VIEW_PATH
        r = run(name, ["two-view", "--left", str(lp), "--right", str(rp), "--output",
                       str(out_dir), *extra], needed)
        args = cli.build_parser().parse_args(["two-view", "--left", ".", "--right", ".", *extra])
        cfg = cli.load_config(args)
        left = torch.from_numpy(load_image_gray(str(lp))).to("cuda")
        right = torch.from_numpy(load_image_gray(str(rp))).to("cuda")
        if cascade:
            out = cascade_two_view_disparity(
                left, right, cfg.cost, cfg.sgm, coarse_factor=args.coarse_factor,
                fine_disparities=args.fine_disparities, band_step=args.band_step,
                mode=args.cascade_mode, backend="torch")
        else:
            out = two_view_disparity(left, right, cfg.cost, cfg.sgm, backend="torch")
        check.arrays(out_dir / "two_view.npz", {"disparity": out.disparity, "valid": out.valid,
                                                "confidence": out.confidence}, f"{name}/")
        check.png(out_dir / "disparity.png", out.disparity, f"{name}/")
        check.png(out_dir / "confidence.png", out.confidence, f"{name}/", vmin=0.0, vmax=1.0)
        check.value(f"{name}/valid_fraction", r["json"]["valid_fraction"],
                    float(out.valid.cpu().numpy().mean()))
    pair = load_middlebury_pair(str(fixture))
    if not (np.array_equal(load_image_gray(str(fixture / "im0.png")), pair.left)
            and np.array_equal(load_image_gray(str(fixture / "im1.png")), pair.right)):
        fail("the CLI's loader decodes data/eval_scene differently from phase 5's")

    # 5 / 5g. evaluate the fixture runs against the ground truth as a .npz
    gt = read_pfm(str(fixture / "disp0.pfm"))
    x = np.arange(gt.shape[1])[None, :]
    with np.errstate(invalid="ignore"):
        matchable = np.isfinite(gt) & (gt > 0) & (x >= np.ceil(gt))
    gt_file = scratch / "fixture_gt.npz"
    # unmatchable pixels carry 0, so --positive-gt-only masks phase 5's pixels
    save_array(str(gt_file), {"disparity": np.where(matchable, gt, 0.0).astype(np.float32)})
    golden = {}
    for dtype in ("int16", "int8"):
        name = f"evaluate_fixture_{dtype}"
        result = scratch / f"two_view_fixture_{dtype}" / "two_view.npz"
        r = run(name, ["evaluate", "--result", str(result), "--ground-truth", str(gt_file),
                       "--key", "disparity"])
        arrays = load_array(str(result))[0]
        pred = torch.from_numpy(arrays["disparity"]).to("cuda")
        g = torch.from_numpy(np.where(matchable, gt, 0.0).astype(np.float32)).to("cuda")
        valid = torch.from_numpy(arrays["valid"]).to("cuda") & (g > 0)
        direct = {"masked_mean_err": masked_mean_error(pred, g, mask=valid),
                  "epe": end_point_error(pred, g, mask=valid),
                  **{f"bad_{t}": bad_pixel_ratio(pred, g, t, mask=valid) for t in (0.5, 1.0, 2.0)}}
        for k, v in direct.items():
            check.value(f"{name}/{k}", r["json"][k], float(v))
        golden[dtype] = {"bad_2.0": r["json"]["bad_2.0"], "epe": r["json"]["epe"],
                         "density": r["json"]["valid_fraction"] / float(matchable.mean())}

    # 6. calibrate the 25 rendered views, with the distortion solve
    cal_dir = scratch / "calibrate"
    r = run("calibrate", ["calibrate", "--input", str(data), "--output", str(cal_dir),
                          "--estimate-distortion"])
    cfg = cli_config(["calibrate", "--input", "."])
    cal = calibrate_array(images, cli._rig_from_config(cfg, (h, w)), cli._center_index(cfg),
                          cfg.sfm, estimate_distortion=True)
    check.arrays(cal_dir / "calibration.npz", {"R": cal.cameras.R, "t": cal.cameras.t,
                                              "points": cal.points,
                                              "point_valid": cal.point_valid}, "calibrate/")
    for key, v in (("num_obs", int(cal.num_obs)), ("mean_reproj_px", float(cal.mean_reproj)),
                   ("inlier_reproj_px", float(cal.inlier_reproj)),
                   ("k1", float(cal.distortion[0])), ("k2", float(cal.distortion[1]))):
        check.value(f"calibrate/{key}", r["json"][key], v)

    # 7. reconstruct all 25 views at the CROSS config
    rec_dir = scratch / "reconstruct"
    run("reconstruct", ["reconstruct", "--input", str(data), "--output", str(rec_dir),
                        *CLI_ARRAY], ARRAY_PATH)
    cfg = cli_config(["reconstruct", "--input", ".", *CLI_ARRAY])
    cams = cli._rig_from_config(cfg, (h, w)).to("cuda")
    views = tuple(range(len(paths)))
    res, _ = reconstruct_array(images, cams, cfg, view_indices=views, backend="torch")
    pts, conf, col = fused_point_cloud(res, images)
    nrm = torch.stack([depth_normals(cams[k], res.depth[k], res.valid[k])[0] for k in views])
    c8 = np.clip(col, 0, 255).astype(np.uint8)
    check.ply(rec_dir / "fused_cloud.ply", pts, colors=np.stack([c8] * 3, axis=-1),
              normals=nrm.cpu().numpy().reshape(-1, 3)[res.valid.cpu().numpy().reshape(-1)],
              quality=conf, tag="reconstruct/")
    check.arrays(rec_dir / "fused.npz", {"depths": res.depth, "valid": res.valid,
                                         "support": res.support, "confidence": res.confidence,
                                         "views": np.asarray(views)}, "reconstruct/")

    # 8. serve phase 4e's eight frame-sets, chunked by 4, with the temporal filter
    srv_dir = scratch / "serve"
    run("serve", ["serve", *served_dirs, "--output", str(srv_dir), "--chunk", "4", "--temporal",
                  *CLI_ARRAY], ARRAY_PATH)
    cfg = cli_config(["serve", ".", *CLI_ARRAY])
    cams = cli._rig_from_config(cfg, (h, w)).to("cuda")
    ref, src = reference_and_sources(cfg, len(paths))
    b0, f_px = array_baselines(cams, ref, src)[1], float(cams.host().fx[ref])
    state = temporal_init((h, w), "cuda")
    for i, d in enumerate(sorted(served_dirs)):
        x = torch.from_numpy(load_image_stack(list_images_sorted(d))).to("cuda")
        out = array_depth_pipeline(x, cams, cfg, backend="torch")
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence)
        depth = torch.where(tout.valid, disparity_to_depth(tout.disparity, b0, f_px), 0.0)
        check.arrays(srv_dir / f"depth_{i:04d}.npz", {"depth": depth, "valid": tout.valid,
                                                     "stability": tout.stability}, "serve/")
        check.png(srv_dir / f"depth_{i:04d}.png", depth, "serve/")
    check.value("serve/frames", runs["serve"]["json"]["frames"], len(served_dirs))

    # 9. inspect depth.npz
    cross_npz = scratch / "depth_cross" / "depth.npz"
    r = run("inspect", ["inspect", str(cross_npz), "--at", str(w // 2), str(h // 2)])
    arrays = load_array(str(cross_npz))[0]
    for k, a in arrays.items():
        check.value(f"inspect/{k}.at", r["json"][k]["at"]["value"], a[h // 2, w // 2].item())

    # the module's entry point in its own process: the in-process CROSS run's artifacts
    sub_dir = scratch / "depth_cross_process"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stereovisionarray_tpu_torch", "depth",
                           "--input", str(data), "--output", str(sub_dir), *CLI_ARRAY],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"python -m stereovisionarray_tpu_torch depth exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    want = load_array(str(cross_npz))[0]
    check.arrays(sub_dir / "depth.npz", want, "process/")
    check.same("process/cloud.ply", (sub_dir / "cloud.ply").read_bytes()
               == (scratch / "depth_cross" / "cloud.ply").read_bytes())

    off = {k: v for k, v in check.errs.items() if v != 0.0}
    emit({"phase": "cli", "runs": {n: {"json": r["json"],
                                       "launches": {k: c for k, c in r["launches"].items() if c},
                                       "wall_ms": r["wall_ms"]} for n, r in runs.items()},
          "artifacts_checked": len(check.errs), "max_abs_err_vs_direct": off,
          "process": {"returncode": proc.returncode, "wall_s": process_s}, **tag})
    if off:
        fail(f"CLI artifacts differ from the direct calls: {off}")
    misses = {}
    for dtype, got in golden.items():
        want = GOLDEN[dtype]
        miss = {m: got[m] - want[m] for m in want if abs(got[m] - want[m]) > GOLDEN_TOL}
        emit({"phase": "cli_golden", "dtype": dtype, "metrics": got, "reference": want,
              "tolerance": GOLDEN_TOL, **tag})
        if miss:
            misses[dtype] = miss
    if misses:
        fail(f"the CLI's evaluate of the fixture is off GOLDEN by {misses}")
    return {"totals": totals, "runs": runs, "images": images, "data": data,
            "served_dirs": served_dirs, "process_s": process_s}


def cli_timing(torch, tag, scratch: Path, state) -> None:
    """Phase 6g: each subcommand's in-process wall (host clock; CUDA events
    around the call) beside the direct call it wraps on inputs already on the
    card (kernels, host clock to a synchronize): the difference is the CLI's
    own decode, host copies and file writes, split for the fixture's
    two-view; and the `python -m` process beside a process that only starts."""
    from stereovisionarray_tpu_torch import cli
    from stereovisionarray_tpu_torch.datasets import (
        list_images_sorted,
        load_array,
        load_image_gray,
        load_image_stack,
        save_array,
        save_png,
    )
    from stereovisionarray_tpu_torch.models import (
        TemporalParams,
        array_baselines,
        calibrate_array,
        reference_and_sources,
        stream_depth_maps_chunked,
        two_view_disparity,
    )
    from stereovisionarray_tpu_torch.models.fusion import fused_point_cloud, reconstruct_array

    images, data = state["images"], state["data"]
    h, w = images.shape[1:]

    cross = cli_config(["depth", "--input", ".", *CLI_ARRAY])
    cams = cli._rig_from_config(cross, (h, w)).to("cuda")
    fixture = REPO / "data" / "eval_scene"
    fcfg = cli_config(["two-view", "--left", ".", "--right", ".", *CLI_FIXTURE])
    fl, fr = (torch.from_numpy(load_image_gray(str(fixture / f))).to("cuda")
              for f in ("im0.png", "im1.png"))
    stacks = [load_image_stack(list_images_sorted(d)) for d in sorted(state["served_dirs"])]
    ref, src = reference_and_sources(cross, len(images))
    params = TemporalParams(baseline=array_baselines(cams, ref, src)[1],
                            focal_px=float(cams.host().fx[ref]))
    cal_cfg = cli_config(["calibrate", "--input", "."])
    cal_rig = cli._rig_from_config(cal_cfg, (h, w))

    def serve_direct():  # the stream over decoded sets, each result copied back
        for res in stream_depth_maps_chunked(iter(stacks), cams, cross, chunk=4,
                                             temporal=params, device="cuda"):
            res.depth.cpu()

    def uncounted(run):
        rc = run()
        torch.cuda.synchronize()
        return rc, None, None

    cases = (
        ("depth", ["depth", "--input", str(data), "--output", str(scratch / "t_depth"),
                   *CLI_ARRAY], lambda: cli_depth_direct(torch, images, cams, cross, "auto"), 2),
        ("two-view", ["two-view", "--left", str(fixture / "im0.png"), "--right",
                      str(fixture / "im1.png"), "--output", str(scratch / "t_tv"), *CLI_FIXTURE],
         lambda: two_view_disparity(fl, fr, fcfg.cost, fcfg.sgm), 2),
        ("evaluate", ["evaluate", "--result",
                      str(scratch / "two_view_fixture_int16" / "two_view.npz"),
                      "--ground-truth", str(scratch / "fixture_gt.npz"), "--key", "disparity"],
         None, 2),
        ("reconstruct", ["reconstruct", "--input", str(data), "--output",
                         str(scratch / "t_rec"), *CLI_ARRAY],
         lambda: fused_point_cloud(reconstruct_array(images, cams, cross)[0], images), 1),
        ("calibrate", ["calibrate", "--input", str(data), "--output", str(scratch / "t_cal"),
                       "--estimate-distortion"],
         lambda: calibrate_array(images, cal_rig, ref, cal_cfg.sfm, estimate_distortion=True),
         1),
        ("serve", ["serve", *state["served_dirs"], "--output", str(scratch / "t_srv"),
                   "--chunk", "4", "--temporal", *CLI_ARRAY], serve_direct, 1),
        ("render", ["render", "--output", str(scratch / "t_render")], None, 1),
        ("inspect", ["inspect", str(scratch / "depth_cross" / "depth.npz")], None, 1),
    )
    for name, argv, direct, rounds in cases:
        cli_ms, cli_events, direct_ms = [], [], []
        for _ in range(rounds):
            r = cli_run(torch, uncounted, argv)
            cli_ms.append(r["wall_ms"])
            cli_events.append(r["events_ms"])
            if direct is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                direct()
                torch.cuda.synchronize()
                direct_ms.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "timing", "metric": "cli_ms", "subcommand": name, "rounds": rounds,
              "cli_wall_ms": cli_ms, "cli_events_ms": cli_events,
              "direct_wall_ms": direct_ms or None,
              "cli_overhead_ms": [c - d for c, d in zip(cli_ms, direct_ms)] or None, **tag})
    # the CLI's own host work on the fixture's two-view, part by part
    tv = load_array(str(scratch / "two_view_fixture_int16" / "two_view.npz"))[0]
    parts = {}
    for part, fn in (
            ("decode_pair", lambda: [load_image_gray(str(fixture / f))
                                     for f in ("im0.png", "im1.png")]),
            ("save_array", lambda: save_array(str(scratch / "t_part.npz"), tv)),
            ("save_png_x2", lambda: (save_png(str(scratch / "t_part.png"), tv["disparity"]),
                                     save_png(str(scratch / "t_part.png"), tv["confidence"],
                                              vmin=0.0, vmax=1.0)))):
        t0 = time.perf_counter()
        fn()
        parts[f"{part}_ms"] = (time.perf_counter() - t0) * 1e3
    emit({"phase": "timing", "metric": "cli_host_parts_ms", "subcommand": "two-view",
          "shape": list(tv["disparity"].shape), **parts, **tag})
    # the process: its start (interpreter, torch, the card's context) and the run
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch, stereovisionarray_tpu_torch.cli; "
                    "torch.zeros(1, device='cuda')"], cwd=REPO, check=True, timeout=300)
    emit({"phase": "timing", "metric": "cli_process_s", "subcommand": "depth",
          "config": "CROSS", "wall_s": state["process_s"],
          "start_only_s": time.perf_counter() - t0, **tag})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")

    from stereovisionarray_tpu_torch import _native, config
    from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair
    from stereovisionarray_tpu_torch.evaluation import bad_pixel_ratio, end_point_error
    from stereovisionarray_tpu_torch.models.two_view import scaled_penalties, two_view_disparity
    from stereovisionarray_tpu_torch.ops.cost_cuda import _tile_plan as cost_tile_plan
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.extract_cuda import extract_maps, lr_gather
    from stereovisionarray_tpu_torch.ops.sgm import p2_maps, sum_dtype
    from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_paths
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.evaluation import array_depth_metrics
    from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
    from stereovisionarray_tpu_torch.models.array_pipeline import (
        _shift_warp_pad,
        array_baselines,
        array_depth_pipeline,
        reference_and_sources,
    )
    from stereovisionarray_tpu_torch.ops.refine import multiview_refine
    from stereovisionarray_tpu_torch.ops.refine_cuda import refine_pass
    from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts
    from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census
    from stereovisionarray_tpu_torch.evaluation import (
        cascade_depth_metrics,
        cascade_disparity_metrics,
    )
    from stereovisionarray_tpu_torch.models.cascade import SMOOTH_R
    from stereovisionarray_tpu_torch.ops.hatsample import hat_sample, hat_sample_2d
    from stereovisionarray_tpu_torch.models.plane_sweep import plane_sweep_depth
    from stereovisionarray_tpu_torch.ops.extract_cuda import _tile_plan, extract_disparity_maps
    from stereovisionarray_tpu_torch.ops.sgm import ALL_SWEEPS, ORDERS
    from stereovisionarray_tpu_torch.ops.sgm_cuda import (
        sgm_aggregate_float,
        sgm_aggregate_hwd,
        sgm_extract_fused,
        sweep_pair,
        _strip_plan,
    )

    CostConfig, SGMConfig = config.CostConfig, config.SGMConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    card = device_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    tag = {"card": card}

    # ---- 2. build --------------------------------------------------------
    build_s = _native.timed_build()
    emit({"phase": "build", "seconds": build_s, **tag})

    kernels = [
        {"name": "K1 cost_volume", "fn": fused_cost_volume_cuda,
         "source": "stereovisionarray_tpu_torch/csrc/cost_volume.cu",
         "replaces": "stereovisionarray_tpu/ops/cost_pallas.py:189"},
        {"name": "K2/K3 sgm_paths", "fn": sgm_aggregate_paths,
         "source": "stereovisionarray_tpu_torch/csrc/sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:1106"},
        {"name": "K4 extract_maps", "fn": extract_maps,
         "source": "stereovisionarray_tpu_torch/csrc/extract.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:820"},
        {"name": "K5 lr_gather", "fn": lr_gather,
         "source": "stereovisionarray_tpu_torch/csrc/extract.cu",
         "replaces": "stereovisionarray_tpu/ops/extract_pallas.py:231"},
        # K5's gather and the reference's LR test inside K4's / K6's launch
        {"name": "K5 lr_check fused", "fn": lr_gather, "counter": "fused_launches",
         "source": "stereovisionarray_tpu_torch/csrc/extract.cu",
         "replaces": "stereovisionarray_tpu/ops/extract_pallas.py:231"},
    ]
    k5, k5f = kernels[3], kernels[4]
    for k in kernels:
        k["max_abs_err"] = 0.0
    # what the integer two-view path must launch; the standalone K5 it must not
    integer_path = ["K1 cost_volume", "K2/K3 sgm_paths", "K4 extract_maps", k5f["name"]]

    def count(k) -> int:
        return getattr(k["fn"], k.get("counter", "launches"))

    def zero(k) -> None:
        setattr(k["fn"], k.get("counter", "launches"), 0)

    sgm_cfg = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True,
                        uniqueness=0.95, lr_max_diff=1.5)

    def stage_inputs(h, w, D, dtype, num_paths, seed):
        """Every kernel's call at one shape, kernel and plain, on one set of inputs."""
        cc = CostConfig(num_disparities=D, census_window=(7, 9), dtype=dtype)
        pen = scaled_penalties(cc, sgm_cfg, dtype)
        left, right = stereo_pair(torch, h, w, seed, integer=True)
        p2_y, p2_x = p2_maps((h, w), pen.p2, sum_dtype(pen.dtype), left.device, left, True,
                             pen.p2_min)
        vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, pen.dtype)
        total = sgm_aggregate_paths(vol, p2_y, p2_x, pen.p1, num_paths)
        maps = extract_maps(total, True, 0.95)
        calls = [
            lambda b: fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, pen.dtype, b),
            lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, pen.p1, num_paths, b),
            lambda b: extract_maps(total, True, 0.95, b),
            lambda b: lr_gather(maps.disparity, maps.disparity_right, D, b),
            # the integer path's extraction: the LR check fused, no right map
            lambda b: extract_maps(total, True, 0.95, b, lr_max_diff=1.5, right=False),
        ]
        return calls

    # ---- 3. kernel parity --------------------------------------------------
    for h, w, D, dtype, num_paths in ((540, 768, 64, "int8", 8), (540, 768, 64, "int16", 8),
                                      (541, 766, 48, "int16", 8), (541, 766, 48, "int8", 4)):
        calls = stage_inputs(h, w, D, dtype, num_paths, seed=h + D)
        errs = {}
        for k, call in zip(kernels, calls):
            got, want = call("cuda"), call("torch")
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max(max_err(torch, a, b) for a, b in pairs)
            torch.cuda.synchronize()
            errs[k["name"]] = err
            k["max_abs_err"] = max(k["max_abs_err"], err)
        emit({"phase": "kernel_parity", "shape": [h, w, D], "dtype": dtype,
              "num_paths": num_paths, "max_abs_err": errs, **tag})
        bad = [n for n, e in errs.items() if e != 0.0]
        if bad:
            fail(f"kernels differ from their plain versions at {h}x{w}x{D} {dtype}: {bad}")

    # K2/K3's int16 accumulation where the 8-path int32 sum passes 32767 (the
    # total wraps), and at the flat cascade's 256 disparities (the staged form
    # with 8 values a lane)
    k23 = kernels[1]
    for h, w, D, dtype, lo, hi in ((540, 768, 64, torch.int16, 3000, 9000),
                                   (540, 768, 256, torch.int8, 0, 71)):
        rng = np.random.default_rng(D)
        vol = torch.from_numpy(rng.integers(lo, hi, (h, w, D)).astype(
            "int16" if dtype == torch.int16 else "int8")).cuda()
        left, _ = stereo_pair(torch, h, w, seed=D, integer=True)
        p2_y, p2_x = p2_maps((h, w), 384, torch.int16, left.device, left, True, 96)
        got = sgm_aggregate_paths(vol, p2_y, p2_x, 32, 8, "cuda")
        want = sgm_aggregate_paths(vol, p2_y, p2_x, 32, 8, "torch")
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        k23["max_abs_err"] = max(k23["max_abs_err"], err)
        emit({"phase": "kernel_parity", "kernel": k23["name"], "shape": [h, w, D],
              "dtype": str(dtype).split(".")[1], "costs": [lo, hi],
              "int16_total_wraps": bool(want.min() < 0) if lo else None, "max_abs_err": err,
              **tag})
        if err != 0.0:
            fail(f"K2/K3 differs from its plain version at {h}x{w}x{D} costs {lo}-{hi}: {err}")
        del vol, got, want

    # ---- 3b. K8 parity -------------------------------------------------------
    k8 = {"name": "K8 plane_sweep", "fn": plane_sweep_census, "max_abs_err": 0.0,
          "launches": 0,  # not on the two-view path
          "source": "stereovisionarray_tpu_torch/csrc/plane_sweep.cu",
          "replaces": "stereovisionarray_tpu/ops/sweep_pallas.py:67"}
    rows, cols, AH, AW, AD = ARRAY_SHAPE

    def array_config(planes, **overrides):
        return config.EngineConfig().override(**{
            "camera.rows": rows, "camera.cols": cols, "plane_sweep.num_planes": planes,
            **overrides})

    def array_scene(h, w):
        cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(h, w))
        images, depths = render_camera_array(cams, (h, w))
        return cams, torch.from_numpy(images).cuda(), depths

    def sweep_args(cams, images, cfg):
        """K8's inputs and fusion at `cfg`, as plane_sweep_volume derives them."""
        ps = cfg.plane_sweep
        ref_index, src = reference_and_sources(cfg, images.shape[0])
        if _shift_warp_pad(cams, ref_index, src, cfg) <= 0:
            fail("the reference rig is not translation-only")
        depths = inverse_depth_samples(ps.z_near, ps.z_far, ps.num_planes)
        shifts = translation_shifts(cams, ref_index, src, depths).swapaxes(0, 1)
        fusion = dict(patch=ps.patch, valid_mean=ps.fusion == "mean",
                      topk=ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None)
        return (images[ref_index].contiguous(), images[list(src)].contiguous(),
                torch.from_numpy(np.ascontiguousarray(shifts)).cuda()), fusion

    cams, images, depths = array_scene(AH, AW)
    odd_cams, odd_images, _ = array_scene(271, 361)
    k8_cases = (
        ("cross", cams, images, array_config(AD, **{"plane_sweep.topology": "CROSS"})),
        ("to_center", cams, images, array_config(AD)),
        ("valid_mean", cams, images, array_config(AD, **{"plane_sweep.fusion": "mean"})),
        ("patch3", cams, images, array_config(AD, **{"plane_sweep.topology": "CROSS",
                                                     "plane_sweep.patch": 3})),
        ("patch7", cams, images, array_config(AD, **{"plane_sweep.topology": "CROSS",
                                                     "plane_sweep.patch": 7})),
        ("odd", odd_cams, odd_images, array_config(97)),
    )
    for name, c, imgs, cfg in k8_cases:
        args, fusion = sweep_args(c, imgs, cfg)
        got = plane_sweep_census(*args, **fusion, backend="cuda")
        want = plane_sweep_census(*args, **fusion, backend="torch")
        torch.cuda.synchronize()
        err = max(max_err(torch, a, b) for a, b in zip(got, want))
        k8["max_abs_err"] = max(k8["max_abs_err"], err)
        emit({"phase": "k8_parity", "case": name, "shape": list(got[0].shape),
              "sources": args[1].shape[0], **fusion, "max_abs_err": err, **tag})
        if err != 0.0:
            fail(f"K8 differs from its plain version in case {name}: {err}")

    # the kernel's routes beyond the main path's: shifts that move by more than
    # a tile from plane to plane (random, +-70 px), patch 9 and top-9 (the
    # generic kernel: census words and top-k slots in shared memory)
    args, fusion = sweep_args(cams, images, array_config(AD))
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.uniform(-70, 70, tuple(args[2].shape)).astype(np.float32)).cuda()
    for name, call in (
            ("wide_shifts", lambda b: plane_sweep_census(args[0], args[1], wide, 5, False, 6, b)),
            ("generic_patch9", lambda b: plane_sweep_census(args[0], args[1][:4],
                                                            args[2][:, :4].contiguous(), 9,
                                                            False, None, b)),
            ("generic_top9", lambda b: plane_sweep_census(args[0], args[1], args[2], 5, False, 9,
                                                          b))):
        got, want = call("cuda"), call("torch")
        torch.cuda.synchronize()
        err = max(max_err(torch, a, b) for a, b in zip(got, want))
        k8["max_abs_err"] = max(k8["max_abs_err"], err)
        emit({"phase": "k8_parity", "case": name, "shape": list(got[0].shape),
              "max_abs_err": err, **tag})
        if err != 0.0:
            fail(f"K8 differs from its plain version in case {name}: {err}")

    # ---- 3c. K9 parity -------------------------------------------------------
    k9 = {"name": "K9 hat_sample", "fn": hat_sample, "max_abs_err": 0.0,
          "launches": 0, "array_launches": 0,  # on neither earlier path
          "source": "stereovisionarray_tpu_torch/csrc/hat_sample.cu",
          "replaces": "stereovisionarray_tpu/ops/hatsample.py:41"}
    CH, CW, _ = CASCADE_SHAPE
    tv_cost, tv_sgm, tv_kw = two_view_cascade_config(CostConfig, SGMConfig)
    casc_cfg = array_config(AD, **ARRAY_CASCADE)
    c_ref, c_src = reference_and_sources(casc_cfg, rows * cols)
    pre_r = _shift_warp_pad(cams, c_ref, c_src, casc_cfg) + 1  # the array pre-warp's half-range
    k9_cases = (  # name, shape, k0, k1, aux table, axis
        ("two_view_warp", (CH, CW), -SMOOTH_R, SMOOTH_R, True, -1),
        ("two_view_decode", (CH, CW), 0, tv_kw["fine_disparities"] - 1, False, -1),
        ("array_prewarp_rows", (len(c_src), AH, AW), -pre_r, pre_r, False, -2),
        ("array_prewarp_cols", (len(c_src), AH, AW), -pre_r, pre_r, False, -1),
    )

    def k9_call(case, seed, outside=False):
        """K9's call at a case's shape on random maps: b -> output."""
        _, shape, k0, k1, aux, axis = case
        rng = np.random.default_rng(seed)
        values = torch.from_numpy(rng.uniform(0.0, 255.0, shape).astype(np.float32)).cuda()
        lo, hi = (k0 - 40.0, k1 + 40.0) if outside else (k0 - 1.5, k1 + 1.5)
        t = torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).cuda()
        a = (torch.from_numpy(rng.uniform(0.0, 200.0, shape[-1]).astype(np.float32)).cuda()
             if aux else None)
        return lambda b: hat_sample(values, t, k0, k1, aux=a, axis=axis, backend=b)

    for i, case in enumerate(k9_cases):
        for outside in (False, True):
            call = k9_call(case, i, outside)
            got, want = call("cuda"), call("torch")
            torch.cuda.synchronize()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max(max_err(torch, a, b) for a, b in pairs)
            k9["max_abs_err"] = max(k9["max_abs_err"], err)
            emit({"phase": "k9_parity", "case": case[0], "shape": list(case[1]),
                  "taps": [case[2], case[3]], "axis": case[5], "aux": case[4],
                  "t_outside_range": outside, "max_abs_err": err, **tag})
            if err != 0.0:
                fail(f"K9 differs from its plain version in case {case[0]}: {err}")

    # K9's 2-D form at the array pre-warp: one launch for both passes
    k9_2d = {"name": "K9 hat_sample_2d", "fn": hat_sample_2d, "max_abs_err": 0.0,
             "launches": 0, "array_launches": 0,  # on neither earlier path
             "source": "stereovisionarray_tpu_torch/csrc/hat_sample.cu",
             "replaces": "stereovisionarray_tpu/ops/hatsample.py:41"}
    prewarp_shape = (len(c_src), AH, AW)

    def k9_2d_call(seed, outside=False):
        """hat_sample_2d at the pre-warp's shape on random maps: (b -> output,
        the two 1-D K9 launches it replaces)."""
        rng = np.random.default_rng(seed)
        values = torch.from_numpy(rng.uniform(0.0, 255.0, prewarp_shape).astype(np.float32)).cuda()
        lo, hi = (-pre_r - 40.0, pre_r + 40.0) if outside else (-pre_r - 1.5, pre_r + 1.5)
        t_rows, t_cols = (torch.from_numpy(rng.uniform(lo, hi, prewarp_shape).astype(np.float32))
                          .cuda() for _ in range(2))
        return (lambda b: hat_sample_2d(values, t_rows, t_cols, -pre_r, pre_r, b),
                lambda: hat_sample(hat_sample(values, t_rows, -pre_r, pre_r, axis=-2), t_cols,
                                   -pre_r, pre_r))

    for outside in (False, True):
        call, two_passes = k9_2d_call(len(k9_cases), outside)
        got = call("cuda")
        errs = {"plain": max_err(torch, got, call("torch")),
                "two_k9_launches": max_err(torch, got, two_passes())}
        torch.cuda.synchronize()
        k9_2d["max_abs_err"] = max(k9_2d["max_abs_err"], *errs.values())
        emit({"phase": "k9_parity", "case": "array_prewarp_2d", "shape": list(prewarp_shape),
              "taps": [-pre_r, pre_r], "t_outside_range": outside, "max_abs_err": errs, **tag})
        if any(e != 0.0 for e in errs.values()):
            fail(f"K9's 2-D form differs: {errs}")

    # ---- 3d. float kernel parity ------------------------------------------------
    src_csrc = "stereovisionarray_tpu_torch/csrc/"
    float_kernels = [
        {"name": "K6 extract_volume", "fn": extract_disparity_maps,
         "source": src_csrc + "extract.cu",
         "replaces": "stereovisionarray_tpu/ops/extract_pallas.py:218"},
        # K7's two routes: the strip route every full-sweep call takes, and
        # the generic form (sweep subsets, D % 8 != 0, unaligned costs)
        {"name": "K7 strips", "fn": sgm_aggregate_float, "source": src_csrc + "sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:430"},
        {"name": "K7 generic", "fn": sgm_aggregate_float, "counter": "generic_launches",
         "source": src_csrc + "sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:430"},
        {"name": "K10 sgm_aggregate_hwd", "fn": sgm_aggregate_hwd,
         "source": src_csrc + "sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:89"},
        {"name": "K11 sweep_pair", "fn": sweep_pair, "source": src_csrc + "sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:326"},
        {"name": "K12 sgm_extract_fused", "fn": sgm_extract_fused,
         "source": src_csrc + "sgm_paths.cu",
         "replaces": "stereovisionarray_tpu/ops/sgm_pallas.py:599"},
    ]
    k6, k7, k7g, k10, k11, k12 = float_kernels
    for k in float_kernels:  # on none of the integer paths
        k.update(max_abs_err=0.0, launches=0, array_launches=0, cascade_launches=0)
    float_sgm = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True, uniqueness=0.95,
                          lr_max_diff=1.5)

    def float_inputs(h, w, D, seed):
        """The float route's inputs at one shape: K1 float32 costs and the
        adaptive float P2 maps of the left image."""
        left, right = stereo_pair(torch, h, w, seed)
        vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, "float32")
        p2_y, p2_x = p2_maps((h, w), 96.0, torch.float32, left.device, left, True, 24.0)
        return left, right, vol, p2_y, p2_x

    def k7_route(call, route):
        """(kernel output, plain output) of a K7 call that must take `route`:
        "strips" (``launches``) or "generic" (``generic_launches``)."""
        before = (sgm_aggregate_float.launches, sgm_aggregate_float.generic_launches)
        got = call("cuda")
        ran = (sgm_aggregate_float.launches - before[0],
               sgm_aggregate_float.generic_launches - before[1])
        if ran != ((1, 0) if route == "strips" else (0, 1)):
            fail(f"a K7 call meant for the {route} route counted (strips, generic) = {ran}")
        return got, call("torch")

    def parity(k, got, want, **case):
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max(max_err(torch, a, b) for a, b in pairs)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        emit({"phase": "float_kernel_parity", "kernel": k["name"], **case, "max_abs_err": err,
              **tag})
        if err != 0.0:
            fail(f"{k['name']} differs from its plain version in {case}: {err}")

    for h, w, D in ((540, 768, 64), (541, 766, 48)):
        left, right, vol, p2_y, p2_x = float_inputs(h, w, D, seed=h + D)
        shape = [h, w, D]
        k1_call = lambda b: fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0,  # noqa: E731
                                                   "float32", b)
        parity(kernels[0], k1_call("cuda"), k1_call("torch"), shape=shape, dtype="float32")
        for num_paths in (4, 8):
            call = lambda b: sweep_pair(vol, p2_y, 8.0, num_paths == 8, b)  # noqa: E731
            got, want = call("cuda"), call("torch")
            parity(k11, got, want, shape=shape, num_paths=num_paths)
            parity(k7g, got, want, shape=shape, num_paths=num_paths, call="sweep_pair")
            # a sweep subset: the generic form
            sweeps = ("down", "up", "lr") if D == 64 else ("up", "rl")
            call = lambda b: sgm_aggregate_float(vol, p2_y, p2_x, 8.0, num_paths,  # noqa: E731
                                                 sweeps, backend=b)
            parity(k7g, *k7_route(call, "generic"), shape=shape, num_paths=num_paths,
                   sweeps=list(sweeps))
        total = sgm_aggregate_float(vol, p2_y, p2_x, 8.0)
        for name, v in (("float32_total", total),
                        ("int8_costs", fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0,
                                                              "int8")),
                        ("int16_costs", fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0,
                                                               "int16"))):
            for uq, lr in ((0.95, 1.5), (0.0, 0.0)):  # without LR the right view is skipped
                call = lambda b: extract_disparity_maps(v, True, uq, lr, b)  # noqa: E731
                parity(k6, call("cuda"), call("torch"), shape=shape, volume=name, uniqueness=uq,
                       lr_max_diff=lr)
            for right in (False, True):  # K4's launch with the LR check fused
                call = lambda b: extract_maps(v, True, 0.95, b, lr_max_diff=1.5,  # noqa: E731
                                              right=right)
                parity(k5f, call("cuda"), call("torch"), shape=shape, volume=name,
                       uniqueness=0.95, lr_max_diff=1.5, right_map=right)

    # K7's strip route at every K7_STRIP_ROWS shape, in each order given there,
    # 4 and 8 paths; the plan must give a strip height at each
    for (h, w, D), orders in K7_STRIP_ROWS:
        strip_rows = _strip_plan(h, w, D, 8, ALL_SWEEPS, True)
        if strip_rows is None:
            fail(f"K7's strip plan refuses {h}x{w}x{D}")
        _, _, vol, p2_y, p2_x = float_inputs(h, w, D, seed=h + w + D)
        for num_paths in (4, 8):
            for order in orders:
                call = lambda b: sgm_aggregate_float(vol, p2_y, p2_x, 8.0, num_paths,  # noqa: E731
                                                     order=order, backend=b)
                parity(k7, *k7_route(call, "strips"), shape=[h, w, D], num_paths=num_paths,
                       order=order, strip_rows=strip_rows)
        del vol

    # ---- 3e. the extraction at every shape a path gives it -------------------
    # K4 with and without the right map, K6; the tiled form wherever its plan
    # fits, the generic form (float32, D = 256, LR) where it does not
    extract_forms, extract_errs = [], {}
    for row, kname, (eh, ew, ed), vtype, lr in EXTRACT_ROWS:
        vol = extraction_volume(torch, eh, ew, ed, vtype)
        plan = _tile_plan(ew, ed, vol.element_size(), lr, lr)  # the path's call: no right map
        errs = {}
        for right in ((False, True) if kname == "K4" else (False,)):
            call = extraction_call(extract_maps, extract_disparity_maps, kname, vol, lr, right)
            got, want = call("cuda"), call("torch")
            torch.cuda.synchronize()
            errs[f"right_map_{right}"] = max(max_err(torch, a, b) for a, b in zip(got, want))
        extract_errs[row] = max(errs.values())
        for k in [kernels[2] if kname == "K4" else k6] + ([k5f] if lr else []):
            k["max_abs_err"] = max(k["max_abs_err"], extract_errs[row])
        form = {"row": row, "kernel": kname, "shape": [eh, ew, ed], "dtype": vtype, "lr": lr,
                "form": "tiled" if plan.tiled else "generic", "tile": plan.tile,
                "stride_words": plan.stride_words, "smem_bytes": plan.smem_bytes}
        extract_forms.append(form)
        emit({"phase": "extract_parity", **form, "max_abs_err": errs, **tag})
        if extract_errs[row] != 0.0:
            fail(f"the extraction differs from its plain version at {row}: {errs}")
        if plan.tiled == (row == "float32_d256_lr"):
            fail(f"the extraction's plan at {row} runs the {form['form']} form")
        del vol, got, want

    # ---- 3f. the cost volume at every shape a path gives it ------------------
    # K1's tiled kernel at every path's shape (int8, int16, float32; D = 24,
    # 48, 64, 256; the 5x7 census of the cascade's coarse pass), BT on and off
    # at the bench shape, and its generic form at the last row
    k1 = kernels[0]
    cost_rows = []
    for row, (ch, cw, cd), window, vtype in K1_ROWS:
        left, right = stereo_pair(torch, ch, cw, seed=ch + cd, integer=vtype == "int8")
        plan = cost_tile_plan(ch, cw, cd, window, ELEMENT_BYTES[vtype])
        errs = {}
        for bw in ((0.25, 0.0) if row == "two_view_bench_int8" else (0.25,)):
            got = fused_cost_volume_cuda(left, right, cd, window, bw, 32.0, vtype, "cuda")
            want = fused_cost_volume_cuda(left, right, cd, window, bw, 32.0, vtype, "torch")
            torch.cuda.synchronize()
            errs[f"bt_weight_{bw}"] = max_err(torch, got, want)
            del got, want
        k1["max_abs_err"] = max(k1["max_abs_err"], *errs.values())
        form = {"row": row, "shape": [ch, cw, cd], "window": list(window), "dtype": vtype,
                "form": "tiled" if plan else "generic", "tile": plan.tile if plan else 0,
                "run_bytes": plan.run_bytes if plan else None,
                "chunk_runs": plan.chunk_runs if plan else None,
                "smem_bytes": plan.smem_bytes if plan else None}
        cost_rows.append(form)
        emit({"phase": "cost_parity", **form, "max_abs_err": errs, **tag})
        if any(e != 0.0 for e in errs.values()):
            fail(f"K1 differs from its plain version at {row}: {errs}")
        if (plan is None) != row.startswith("generic"):
            fail(f"K1's plan at {row} runs the {form['form']} form")

    # ---- 4. main path --------------------------------------------------------
    bench_cfg = (CostConfig(num_disparities=64, census_window=(7, 9), dtype="int8"),
                 SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True))
    entry_cfg = (CostConfig(num_disparities=64, census_window=(7, 9)),
                 SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True))
    bench_pair = stereo_pair(torch, BENCH_SHAPE[0], BENCH_SHAPE[1], seed=0)
    entry_pair = stereo_pair(torch, ENTRY_SHAPE[0], ENTRY_SHAPE[1], seed=0, offset=16)
    # R: the refinement's static-stack pass (three launches: rows, columns,
    # select); the reference has no Pallas kernel here
    kr = {"name": "R refine", "fn": refine_pass, "max_abs_err": 0.0,
          "source": "stereovisionarray_tpu_torch/csrc/refine.cu",
          "replaces": "stereovisionarray_tpu/ops/refine.py (plain, no Pallas kernel)"}
    all_kernels = kernels + [k8, k9, k9_2d, kr] + float_kernels
    real_launch = _native.launch
    # (H, W, D, volume bytes, LR, tile) of every extraction launched on a path
    extract_launches = collections.Counter()
    # (H, W, D, volume bytes, tile) of every cost volume launched on a path
    cost_launches = collections.Counter()

    def counted(run):
        """run() with every launch count set to 0 just before: (output, the
        wrappers' counts, the C entry points it launched)."""
        entries = collections.Counter()

        def spy(name, *args):
            entries[name] += 1
            if name == "svt_extract_maps":  # args: device, total, bytes, h, w, D, ..., lr, tile
                extract_launches[(*args[3:6], args[2], args[8] > 0, args[9])] += 1
            if name == "svt_cost_volume":  # device, left, right, out, bytes, h, w, D, ..., tile
                cost_launches[(*args[5:8], args[4], args[14])] += 1
            return real_launch(name, *args)

        for k in all_kernels:
            zero(k)
        _native.launch = spy
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            _native.launch = real_launch
        return out, {k["name"]: count(k) for k in all_kernels}, dict(entries)

    def check_integer_entries(entries, frames, what):
        """The integer two-view path: one extraction launch a frame (the LR
        check inside it), no standalone K5."""
        if entries.get("svt_lr_gather", 0) or entries.get("svt_extract_maps", 0) != frames:
            fail(f"{what} launched {entries}: want {frames} svt_extract_maps, no svt_lr_gather")

    outs, tv_counts, tv_entries = counted(lambda: [two_view_disparity(*bench_pair, *bench_cfg),
                                                   two_view_disparity(*entry_pair, *entry_cfg)])
    for k in all_kernels:
        k["launches"] = tv_counts[k["name"]]
    missing = [n for n in integer_path if tv_counts[n] == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    check_integer_entries(tv_entries, 2, "the main path")
    for name, out, pair, cfg in (("bench", outs[0], bench_pair, bench_cfg),
                                 ("entry", outs[1], entry_pair, entry_cfg)):
        plain = two_view_disparity(*pair, *cfg, backend="torch")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f))
                for f in ("disparity", "valid", "cost", "confidence")}
        h, w = pair[0].shape
        finite = bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
        emit({"phase": "main_path", "run": name, "shape": [h, w, cfg[0].num_disparities],
              "dtype": cfg[0].dtype, "valid_fraction": out.valid.float().mean().item(),
              "launches_both_runs": {n: c for n, c in tv_counts.items() if c},
              "entry_launches_both_runs": tv_entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"main path ({name}) differs from the plain path or is not finite")
        if tuple(out.disparity.shape) != (h, w):
            fail(f"main path ({name}) disparity shape {tuple(out.disparity.shape)}")

    # the integer scans' wrapper: the kernel writes the int16 total, so no
    # zero-fill and no narrowing copy run beside it (the CPU-side ops it calls)
    calls = stage_inputs(*BENCH_SHAPE, "int8", 8, seed=5)
    calls[1]("cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        total = calls[1]("cuda")
    ops = sorted({e.name for e in prof.events()})
    banned = {"aten::zeros", "aten::zero_", "aten::fill_", "aten::to", "aten::_to_copy",
              "aten::copy_"} & set(ops)
    emit({"phase": "main_path", "run": "k2k3_wrapper_ops", "ops": ops,
          "total_dtype": str(total.dtype), **tag})
    if banned or total.dtype != torch.int16:
        fail(f"the integer scans' wrapper ran {sorted(banned)} or returned {total.dtype}")

    # ---- 4b. array main path -------------------------------------------------
    array_cfgs = {"cross": array_config(AD, **{"plane_sweep.topology": "CROSS"}),
                  "to_center": array_config(AD)}
    array_outs, arr_counts, arr_entries = counted(
        lambda: {name: array_depth_pipeline(images, cams, cfg) for name, cfg in array_cfgs.items()})
    for k in all_kernels:
        k["array_launches"] = arr_counts[k["name"]]
    array_kernels = [k8["name"], "K2/K3 sgm_paths", "K4 extract_maps", kr["name"]]
    missing = [n for n in array_kernels if arr_counts[n] == 0]
    if missing:
        fail(f"the array path never launched {missing}")
    if arr_counts[kr["name"]] != 3 * len(array_cfgs):
        fail(f"the array path's refinement launched {arr_counts[kr['name']]} kernels: want "
             f"three a pass")
    for name, cfg in array_cfgs.items():
        out = array_outs[name]
        plain = array_depth_pipeline(images, cams, cfg, backend="torch")
        fields = ("depth", "refined_depth", "disparity", "refined_disparity", "valid")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f)) for f in fields}
        errs.update({f: max_err(torch, getattr(out.sweep, f), getattr(plain.sweep, f))
                     for f in ("plane", "cost", "num_views", "confidence")})
        finite = bool(torch.isfinite(out.refined_depth).all() and torch.isfinite(out.depth).all())
        emit({"phase": "array_main_path", "run": name, "shape": [rows * cols, AH, AW, AD],
              "sources": len(reference_and_sources(cfg, rows * cols)[1]),
              "valid_fraction": out.valid.float().mean().item(),
              "launches_both_runs": {n: c for n, c in arr_counts.items() if c},
              "entry_launches_both_runs": arr_entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"array path ({name}) differs from the plain path or is not finite")
        if tuple(out.refined_depth.shape) != (AH, AW):
            fail(f"array path ({name}) depth shape {tuple(out.refined_depth.shape)}")

    # R against its plain route at the main path's passes: CROSS (4 views,
    # whole-step candidates) and to_center (24 views, the hat blend), radius
    # 5, window 21, on the sweep's disparities; every output, limit 0
    def refine_call(name):
        cfg, out = array_cfgs[name], array_outs[name]
        ref, src = reference_and_sources(cfg, rows * cols)
        bl, _ = array_baselines(cams, ref, src)
        rc = cfg.refine
        ceiling = float(out.disparity.max()) + 2 * abs(rc.radius * rc.step)
        aux = images[list(src)].to(torch.float32)
        return lambda b: multiview_refine(images[ref].to(torch.float32), aux, bl, out.disparity,
                                          mask=out.mask & out.valid, radius=rc.radius,
                                          step=rc.step, window=rc.window, subpixel=rc.subpixel,
                                          max_disparity=ceiling, backend=b)

    refine_calls = {name: refine_call(name) for name in array_cfgs}
    for name, call in refine_calls.items():
        got, want = call("cuda"), call("torch")
        torch.cuda.synchronize()
        errs = {f: max_err(torch, getattr(got, f), getattr(want, f)) for f in got._fields}
        kr["max_abs_err"] = max(kr["max_abs_err"], *errs.values())
        rc = array_cfgs[name].refine
        emit({"phase": "refine_parity", "case": name, "shape": list(got.cost.shape),
              "views": len(reference_and_sources(array_cfgs[name], rows * cols)[1]),
              "radius": rc.radius, "window": rc.window, "max_abs_err": errs, **tag})
        if any(e != 0.0 for e in errs.values()):
            fail(f"R differs from its plain route at the array path's {name} pass: {errs}")

    # ---- 4c. cascade main paths -----------------------------------------------
    tv_left, tv_right, tv_gt, tv_mask = two_view_cascade_scene(torch, images.device)
    tv_run = counted(lambda: two_view_cascade_run(tv_left, tv_right))
    arr_run = counted(lambda: array_depth_pipeline(images, cams, casc_cfg))
    tv_out, arr_out = tv_run[0], arr_run[0]
    for k in all_kernels:
        k["cascade_launches"] = tv_run[1][k["name"]] + arr_run[1][k["name"]]
    tv_needed = {"smooth": integer_path + [k9["name"]], "band": integer_path}
    # the pre-warp: one 2-D K9 launch, no 1-D one
    arr_needed = {"smooth": array_kernels + [k9_2d["name"]], "band": array_kernels}
    tv_fields = ("disparity", "valid", "cost", "confidence", "coarse_disparity", "band_offset")
    sweep_fields = ("depth", "plane", "cost", "valid", "num_views", "confidence")
    for mode in ("smooth", "band"):
        out, launches, entries = (tv_run if mode == "smooth" else
                                  counted(lambda: two_view_cascade_run(tv_left, tv_right, mode)))
        missing = [n for n in tv_needed[mode] if launches[n] == 0]
        if missing:
            fail(f"the two-view cascade ({mode}) never launched {missing}")
        check_integer_entries(entries, 2, f"the two-view cascade ({mode}), coarse and fine,")
        plain = two_view_cascade_run(tv_left, tv_right, mode, backend="torch")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f)) for f in tv_fields}
        finite = bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
        emit({"phase": "cascade_main_path", "run": f"two_view_{mode}", "shape": list(CASCADE_SHAPE),
              "dtype": tv_cost.dtype, **tv_kw, "valid_fraction": out.valid.float().mean().item(),
              "launches": launches, "entry_launches": entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"two-view cascade ({mode}) differs from the plain path or is not finite")
        if tuple(out.disparity.shape) != (CH, CW):
            fail(f"two-view cascade ({mode}) disparity shape {tuple(out.disparity.shape)}")
        cfg = casc_cfg.override(**{"plane_sweep.cascade_mode": mode})
        out, launches, entries = (arr_run if mode == "smooth" else
                                  counted(lambda: array_depth_pipeline(images, cams, cfg)))
        missing = [n for n in arr_needed[mode] if launches[n] == 0]
        if missing:
            fail(f"the array cascade ({mode}) never launched {missing}")
        if entries.get("svt_hat_sample", 0) or entries.get("svt_hat_sample_2d", 0) != (
                mode == "smooth"):
            fail(f"the array cascade ({mode}) pre-warp launched {entries}: want one "
                 "svt_hat_sample_2d in smooth mode, none in band mode, no svt_hat_sample")
        plain = array_depth_pipeline(images, cams, cfg, backend="torch")
        fields = ("depth", "refined_depth", "disparity", "refined_disparity", "valid")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f)) for f in fields}
        errs.update({f"sweep.{f}": max_err(torch, getattr(out.sweep, f), getattr(plain.sweep, f))
                     for f in sweep_fields})
        finite = bool(torch.isfinite(out.refined_depth).all() and torch.isfinite(out.depth).all())
        emit({"phase": "cascade_main_path", "run": f"array_{mode}",
              "shape": [rows * cols, AH, AW, AD], "sources": len(c_src),
              **{k.split(".")[1]: v for k, v in ARRAY_CASCADE.items() if "cascade_" in k},
              "valid_fraction": out.valid.float().mean().item(),
              "launches": launches, "entry_launches": entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"array cascade ({mode}) differs from the plain path or is not finite")
        if tuple(out.refined_depth.shape) != (AH, AW):
            fail(f"array cascade ({mode}) depth shape {tuple(out.refined_depth.shape)}")

    # ---- 4d. float main paths --------------------------------------------------
    for k in all_kernels:
        k["float_launches"] = 0

    def add_float_launches(launches):
        for k in all_kernels:
            k["float_launches"] += launches[k["name"]]

    float_cfgs = {"bench": (CostConfig(num_disparities=64, census_window=(7, 9), dtype="float32"),
                            float_sgm, bench_pair),
                  "entry": (CostConfig(num_disparities=64, census_window=(7, 9), dtype="float32"),
                            float_sgm, entry_pair)}
    tv_float_needed = ["K1 cost_volume", k7["name"], k6["name"], k5f["name"]]
    for name, (cc, sc, pair) in float_cfgs.items():
        out, launches, entries = counted(lambda: two_view_disparity(*pair, cc, sc))
        add_float_launches(launches)
        missing = [n for n in tv_float_needed if launches[n] == 0]
        if missing:
            fail(f"the float two-view path ({name}) never launched {missing}")
        if entries.get("svt_extract_maps", 0) != launches[k6["name"]] or "svt_lr_gather" in entries:
            fail(f"K6 with LR is not one launch on the float two-view path: {entries}")
        if launches[k7g["name"]] or "svt_sgm_paths_f32" in entries:
            fail(f"the float two-view path ({name}) ran K7's generic form: {entries}")
        plain = two_view_disparity(*pair, cc, sc, backend="torch")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f))
                for f in ("disparity", "valid", "cost", "confidence")}
        h, w = pair[0].shape
        finite = bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
        emit({"phase": "float_main_path", "run": f"two_view_{name}",
              "shape": [h, w, cc.num_disparities], "dtype": "float32",
              "valid_fraction": out.valid.float().mean().item(),
              "launches": {n: c for n, c in launches.items() if c}, "entry_launches": entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"float two-view ({name}) differs from the plain path or is not finite")

    zncc_cfg = array_config(AD, **{"plane_sweep.topology": "CROSS", "plane_sweep.cost": "zncc"})
    cross_cfg = array_cfgs["cross"]
    ps_ref, ps_src = reference_and_sources(cross_cfg, rows * cols)
    ps_pad = _shift_warp_pad(cams, ps_ref, ps_src, cross_cfg)
    float_runs = {
        "array_zncc": (lambda b: array_depth_pipeline(images, cams, zncc_cfg, backend=b),
                       [k7["name"], k6["name"], kr["name"]],
                       ("depth", "refined_depth", "disparity", "refined_disparity", "valid")),
        "plane_sweep_no_sgm": (
            lambda b: plane_sweep_depth(images, cams, ps_ref, ps_src, cross_cfg.plane_sweep, None,
                                        backend=b, shift_pad=ps_pad),
            [k8["name"], k6["name"]], sweep_fields),
    }
    for name, (run, needed, fields) in float_runs.items():
        out, launches, entries = counted(lambda: run("auto"))
        add_float_launches(launches)
        missing = [n for n in needed if launches[n] == 0]
        if missing:
            fail(f"the {name} path never launched {missing}")
        if launches[k7g["name"]] or "svt_sgm_paths_f32" in entries:
            fail(f"the {name} path ran K7's generic form: {entries}")
        plain = run("torch")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f)) for f in fields}
        if name == "array_zncc":
            errs.update({f"sweep.{f}": max_err(torch, getattr(out.sweep, f),
                                               getattr(plain.sweep, f)) for f in sweep_fields})
        finite = bool(torch.isfinite(out.depth).all())
        emit({"phase": "float_main_path", "run": name, "shape": [rows * cols, AH, AW, AD],
              "sources": len(ps_src), "valid_fraction": out.valid.float().mean().item(),
              "launches": {n: c for n, c in launches.items() if c}, "entry_launches": entries,
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"{name} differs from the plain path or is not finite")

    # the K10-K12 entry points and the standalone K5, which no pipeline calls,
    # at the bench shape
    fl, fr, fvol, fp2_y, fp2_x = float_inputs(*BENCH_SHAPE, seed=0)
    fmaps = extract_maps(sgm_aggregate_float(fvol, fp2_y, fp2_x, 8.0), True, 0.95)
    api_runs = {
        # the generic form through the public call of a sweep subset
        k7g["name"]: lambda b: sgm_aggregate_float(fvol, fp2_y, fp2_x, 8.0, 8,
                                                   ("down", "up", "lr"), backend=b),
        k10["name"]: lambda b: sgm_aggregate_hwd(fvol, 8.0, 96.0, 8, fl, True, 24.0, b),
        k11["name"]: lambda b: sweep_pair(fvol, fp2_y, 8.0, True, b),
        k12["name"]: lambda b: sgm_extract_fused(fvol, fp2_y, fp2_x, 8.0, 8, True, 0.95, 1.5, b),
        k5["name"]: lambda b: lr_gather(fmaps.disparity, fmaps.disparity_right, BENCH_SHAPE[2], b),
    }
    api_kernels = {k["name"]: k for k in (k7g, k10, k11, k12, k5)}
    for name, run in api_runs.items():
        out, launches, entries = counted(lambda: run("auto"))
        add_float_launches(launches)
        if launches[name] == 0:
            fail(f"{name} never launched its kernels")
        others = {n: c for n, c in launches.items() if c and n != name}
        if others:
            fail(f"{name} counted launches under other kernels: {others}")
        want = run("torch")
        pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
        err = max(max_err(torch, a, b) for a, b in pairs)
        k = api_kernels[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        emit({"phase": "float_main_path", "run": name, "shape": list(BENCH_SHAPE),
              "launches": {n: c for n, c in launches.items() if c}, "entry_launches": entries,
              "max_abs_err_vs_plain": err, **tag})
        if err != 0.0:
            fail(f"{name} differs from its plain version at the bench shape: {err}")

    # which form of the extraction ran at each shape: the plan's rows, and
    # every launch of the paths above, all of them tiled
    path_forms = [{"shape": list(key[:3]), "bytes": key[3], "lr": key[4], "tile": key[5],
                   "form": "tiled" if key[5] else "generic", "launches": n}
                  for key, n in sorted(extract_launches.items())]
    emit({"phase": "extract_forms", "plan_rows": extract_forms, "path_launches": path_forms,
          **tag})
    if any(f["form"] != "tiled" for f in path_forms):
        fail(f"a path ran the extraction's generic form: {path_forms}")
    # the same for K1: every cost volume the paths above launched is tiled
    cost_forms = [{"shape": list(key[:3]), "bytes": key[3], "tile": key[4],
                   "form": "tiled" if key[4] else "generic", "launches": n}
                  for key, n in sorted(cost_launches.items())]
    emit({"phase": "cost_forms", "plan_rows": cost_rows, "path_launches": cost_forms, **tag})
    if not cost_forms or any(f["form"] != "tiled" for f in cost_forms):
        fail(f"a path ran K1's generic form (or none ran K1): {cost_forms}")

    # ---- 5. golden fixture -------------------------------------------------
    pair = load_middlebury_pair(str(REPO / "data" / "eval_scene"))
    gt = torch.from_numpy(pair.gt_disparity).cuda()
    x = torch.arange(gt.shape[1], device=gt.device)[None, :]
    matchable = torch.from_numpy(pair.valid_gt).cuda() & (x >= torch.ceil(gt))
    left = torch.from_numpy(pair.left).cuda()
    right = torch.from_numpy(pair.right).cuda()
    fixture_sgm = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True,
                            uniqueness=0.95, lr_max_diff=1.5)
    for dtype, want in GOLDEN.items():
        cc = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9), dtype=dtype)
        out = two_view_disparity(left, right, cc, fixture_sgm)
        em = matchable & out.valid
        got = {
            "bad_2.0": bad_pixel_ratio(out.disparity, gt, 2.0, mask=em).item(),
            "epe": end_point_error(out.disparity, gt, mask=em).item(),
            "density": ((out.valid & matchable).float().mean()
                        / matchable.float().mean()).item(),
        }
        emit({"phase": "golden", "dtype": dtype, "metrics": got, "reference": want, **tag})
        off = {m: abs(got[m] - want[m]) for m in want if abs(got[m] - want[m]) > GOLDEN_TOL}
        if off:
            fail(f"golden metrics ({dtype}) off the reference by {off}")

    # ---- 5b. array golden ----------------------------------------------------
    golden_cfg = array_config(96, **{"plane_sweep.topology": "CROSS", "refine.radius": 3,
                                     "refine.window": 11})
    g_cams, g_images, g_depths = array_scene(135, 180)
    ref_index = (rows // 2) * cols + cols // 2
    for images_kind, imgs in (("integer", torch.round(g_images)), ("float", g_images)):
        out = array_depth_pipeline(imgs, g_cams, golden_cfg, ref_index=ref_index)
        got = array_depth_metrics(out.depth, out.refined_depth, out.valid, g_depths[ref_index])
        want = ARRAY_GOLDEN if images_kind == "integer" else EVAL_ARRAY_R05
        emit({"phase": "array_golden", "images": images_kind, "metrics": got, "reference": want,
              "gated": images_kind == "integer", **tag})
        if images_kind == "integer":
            off = {m: abs(got[m] - want[m]) for m, tol in ARRAY_GOLDEN_TOL.items()
                   if abs(got[m] - want[m]) > tol}
            if off:
                fail(f"array golden metrics off the reference by {off}")

    # ---- 5c. cascade accuracy --------------------------------------------------
    cascade_metrics = {
        "two_view": cascade_disparity_metrics(tv_out.disparity, tv_gt, tv_mask),
        "array": cascade_depth_metrics(arr_out.refined_depth, arr_out.valid, depths[c_ref]),
    }
    for path, got in cascade_metrics.items():
        want, tol = CASCADE_GOLDEN[path], CASCADE_GOLDEN_TOL[path]
        emit({"phase": "cascade_golden", "path": path, "metrics": got, "reference": want,
              "tolerance": tol, "tpu_v5e_eval_r05": EVAL_CASCADE_R05[path], **tag})
        off = {m: abs(got[m] - want[m]) for m in want if abs(got[m] - want[m]) > tol[m]}
        if off:
            fail(f"cascade golden metrics ({path}) off the reference by {off}")

    # ---- 5d. float golden ---------------------------------------------------------
    eval_r03 = json.loads((REPO / "EVAL_r03.json").read_text())
    cc = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9), dtype="float32")
    out = two_view_disparity(left, right, cc, fixture_sgm)
    em = matchable & out.valid
    got = {
        "bad_2.0": bad_pixel_ratio(out.disparity, gt, 2.0, mask=em).item(),
        "epe": end_point_error(out.disparity, gt, mask=em).item(),
        "density": ((out.valid & matchable).float().mean() / matchable.float().mean()).item(),
    }
    emit({"phase": "float_golden", "dtype": "float32", "metrics": got, "reference": FLOAT_GOLDEN,
          "tolerance": FLOAT_GOLDEN_TOL,
          "eval_r03": {m: eval_r03[m] for m in FLOAT_GOLDEN if m in eval_r03}, **tag})
    off = {m: abs(got[m] - want) for m, want in FLOAT_GOLDEN.items()
           if abs(got[m] - want) > FLOAT_GOLDEN_TOL}
    if off:
        fail(f"float golden metrics off the reference by {off}")

    # ---- 6. timing ------------------------------------------------------------
    h, w, D = BENCH_SHAPE
    for dtype in ("int8", "int16"):
        cfg = (CostConfig(num_disparities=D, census_window=(7, 9), dtype=dtype), bench_cfg[1])
        ms = cuda_ms(torch, lambda: two_view_disparity(*bench_pair, *cfg), TIMED_FRAMES)
        plain_ms = cuda_ms(torch, lambda: two_view_disparity(*bench_pair, *cfg, backend="torch"),
                           PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "metric": "two_view_sgm_throughput", "shape": [h, w, D],
              "dtype": dtype, "frames": TIMED_FRAMES, "ms_per_frame": ms,
              "mp_per_s": h * w / 1e6 / (ms / 1e3), "plain_frames": PLAIN_FRAMES,
              "plain_ms_per_frame": plain_ms, "plain_mp_per_s": h * w / 1e6 / (plain_ms / 1e3),
              **tag})
        calls = stage_inputs(h, w, D, dtype, 8, seed=1)
        for k, call in zip(kernels, calls):
            k_ms = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
            dev_ms = device_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
            p_ms = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
            emit({"phase": "timing", "kernel": k["name"], "shape": [h, w, D], "dtype": dtype,
                  "iters": TIMED_FRAMES, "ms": k_ms, "device_ms": dev_ms,
                  "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})
            if dtype == "int8":  # the bench shape and dtype
                k["ms"], k["device_ms"], k["plain_ms"] = k_ms, dev_ms, p_ms
    # K4 as the flat two-view path runs it at D = 256 (LR, no right map) and as
    # the array paths do (no LR, no right view); bound: the volume read once
    # and four maps written, 6 operations an element with the right view and
    # the LR test's 4 a pixel, else 4
    k4 = kernels[2]
    k4["at_shapes"] = {}
    for row in ("two_view_flat_d256", "array_sgm"):
        _, kname, (eh, ew, ed), vtype, lr = next(r for r in EXTRACT_ROWS if r[0] == row)
        call = extraction_call(extract_maps, extract_disparity_maps, kname,
                               extraction_volume(torch, eh, ew, ed, vtype), lr)
        t_bytes = (eh * ew * ed * 2 + eh * ew * 13) / HBM_BYTES_PER_S * 1e3
        t_ops = (eh * ew * ed * (6 if lr else 4) + eh * ew * (4 if lr else 0)) / F32_OPS_PER_S * 1e3
        k4["at_shapes"][row] = {
            "shape": [eh, ew, ed], "lr": lr,
            "form": next(f["form"] for f in extract_forms if f["row"] == row),
            "max_abs_err": extract_errs[row], "ms": cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
            "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
            "plain_ms": cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit({"phase": "timing", "kernel": k4["name"], "row": row, **k4["at_shapes"][row], **tag})
    # K1 at the other shapes the paths give it (the bench int8 row is K1's own)
    k1["at_shapes"] = {}
    for row in ("two_view_bench_int16", "two_view_bench_float32", "two_view_entry",
                "two_view_flat_d256", "cascade_coarse", "cascade_fine"):
        _, (ch, cw, cd), window, vtype = next(r for r in K1_ROWS if r[0] == row)
        left, right = stereo_pair(torch, ch, cw, seed=ch + cd, integer=vtype == "int8")
        call = lambda b: fused_cost_volume_cuda(left, right, cd, window, 0.25, 32.0,  # noqa: E731
                                                vtype, b)
        t_bytes, t_ops = k1_bound(ch, cw, cd, window, ELEMENT_BYTES[vtype])
        k1["at_shapes"][row] = {
            "shape": [ch, cw, cd], "window": list(window), "dtype": vtype,
            "tile": cost_tile_plan(ch, cw, cd, window, ELEMENT_BYTES[vtype]).tile,
            "ms": cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
            "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
            "plain_ms": cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit({"phase": "timing", "kernel": k1["name"], "row": row, **k1["at_shapes"][row], **tag})

    # ---- 6b. array timing -----------------------------------------------------
    for name, cfg in array_cfgs.items():
        ms = cuda_ms(torch, lambda: array_depth_pipeline(images, cams, cfg), ARRAY_FRAMES)
        plain_ms = cuda_ms(torch, lambda: array_depth_pipeline(images, cams, cfg, backend="torch"),
                           1, warmup=1)
        emit({"phase": "timing", "metric": "array_pipeline_ms_per_frame_set", "run": name,
              "shape": [rows * cols, AH, AW, AD], "frames": ARRAY_FRAMES, "ms_per_frame_set": ms,
              "frame_sets_per_s": 1e3 / ms, "plain_frames": 1, "plain_ms_per_frame_set": plain_ms,
              **tag})
        args, fusion = sweep_args(cams, images, cfg)
        k_ms = cuda_ms(torch, lambda: plane_sweep_census(*args, **fusion, backend="cuda"),
                       TIMED_FRAMES)
        dev_ms = device_ms(torch, lambda: plane_sweep_census(*args, **fusion, backend="cuda"),
                           TIMED_FRAMES)
        p_ms = cuda_ms(torch, lambda: plane_sweep_census(*args, **fusion, backend="torch"),
                       PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": k8["name"], "run": name, "shape": [AH, AW, AD],
              "sources": args[1].shape[0], "iters": TIMED_FRAMES, "ms": k_ms,
              "device_ms": dev_ms, "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})
        k8[f"ms_{name}"], k8[f"device_ms_{name}"], k8[f"plain_ms_{name}"] = k_ms, dev_ms, p_ms
    k8["ms"], k8["device_ms"], k8["plain_ms"] = (k8["ms_cross"], k8["device_ms_cross"],
                                                 k8["plain_ms_cross"])
    # K2/K3 and K4 on the CROSS plane volume, quantized as _volume_to_maps does
    args, fusion = sweep_args(cams, images, array_cfgs["cross"])
    vol, _ = plane_sweep_census(*args, **fusion)
    q = torch.round(vol * 4).to(torch.int8)
    sgm = array_cfgs["cross"].sgm
    p2_y, p2_x = p2_maps((AH, AW), round(sgm.p2 * 4), torch.int16, q.device, args[0],
                         sgm.adaptive_p2, round(sgm.p2_min * 4))
    total = sgm_aggregate_paths(q, p2_y, p2_x, round(sgm.p1 * 4), sgm.num_paths)
    for k, call in ((kernels[1], lambda b: sgm_aggregate_paths(q, p2_y, p2_x, round(sgm.p1 * 4),
                                                                sgm.num_paths, b)),
                    (kernels[2], lambda b: extract_maps(total, True, 0.0, b, right=False))):
        k_ms = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        p_ms = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": k["name"], "run": "array_cross",
              "shape": [AH, AW, AD], "dtype": "int8", "iters": TIMED_FRAMES, "ms": k_ms,
              "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
              "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})

    # R at the array path's passes; bound as the CROSS pass's
    for name, call in refine_calls.items():
        k_ms = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        dev_ms = device_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        p_ms = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": kr["name"], "run": name, "shape": [AH, AW],
              "iters": TIMED_FRAMES, "ms": k_ms, "device_ms": dev_ms,
              "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})
        kr[f"ms_{name}"], kr[f"device_ms_{name}"], kr[f"plain_ms_{name}"] = k_ms, dev_ms, p_ms
    kr["ms"], kr["device_ms"], kr["plain_ms"] = (kr["ms_cross"], kr["device_ms_cross"],
                                                 kr["plain_ms_cross"])

    # ---- 6c. cascade timing ----------------------------------------------------
    runs = {
        "two_view_cascade": lambda b: two_view_cascade_run(tv_left, tv_right, backend=b),
        "two_view_flat": lambda b: two_view_disparity(tv_left, tv_right, tv_cost, tv_sgm,
                                                      backend=b),
        "array_cascade": lambda b: array_depth_pipeline(images, cams, casc_cfg, backend=b),
        "array_flat": lambda b: array_depth_pipeline(images, cams, array_cfgs["cross"], backend=b),
    }
    for name, run in runs.items():
        frames = TIMED_FRAMES if name.startswith("two_view") else ARRAY_FRAMES
        ms = cuda_ms(torch, lambda: run("auto"), frames)
        # the plain flat two-view at 256 disparities runs for seconds a frame: not timed
        plain_ms = (None if name == "two_view_flat"
                    else cuda_ms(torch, lambda: run("torch"), 1, warmup=1))
        shape = list(CASCADE_SHAPE) if name.startswith("two_view") else [rows * cols, AH, AW, AD]
        emit({"phase": "timing", "metric": f"{name}_ms", "shape": shape, "frames": frames,
              "ms": ms, "plain_frames": 1 if plain_ms is not None else 0, "plain_ms": plain_ms,
              **tag})
    for i, case in enumerate(k9_cases):
        call = k9_call(case, i)
        k_ms = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        dev_ms = device_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        p_ms = cuda_ms(torch, lambda: call("torch"), TIMED_FRAMES)
        emit({"phase": "timing", "kernel": k9["name"], "case": case[0], "shape": list(case[1]),
              "taps": [case[2], case[3]], "iters": TIMED_FRAMES, "ms": k_ms,
              "device_ms": dev_ms, "plain_iters": TIMED_FRAMES, "plain_ms": p_ms, **tag})
        if case[0] == "two_view_warp":
            k9["ms"], k9["device_ms"], k9["plain_ms"] = k_ms, dev_ms, p_ms
    # the array pre-warp: K9's 2-D form beside the two 1-D launches it replaces
    call, two_passes = k9_2d_call(len(k9_cases))
    k9_2d["ms"] = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
    k9_2d["device_ms"] = device_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
    k9_2d["plain_ms"] = cuda_ms(torch, lambda: call("torch"), TIMED_FRAMES)
    emit({"phase": "timing", "kernel": k9_2d["name"], "case": "array_prewarp_2d",
          "shape": list(prewarp_shape), "taps": [-pre_r, pre_r], "iters": TIMED_FRAMES,
          "ms": k9_2d["ms"], "device_ms": k9_2d["device_ms"], "plain_iters": TIMED_FRAMES,
          "plain_ms": k9_2d["plain_ms"],
          "two_k9_launches_ms": cuda_ms(torch, two_passes, TIMED_FRAMES),
          "two_k9_launches_device_ms": device_ms(torch, two_passes, TIMED_FRAMES), **tag})

    # ---- 6d. float timing -------------------------------------------------------
    h, w, D = BENCH_SHAPE
    for dtype in ("int8", "float32", "float32", "int8"):  # in turns
        cc = CostConfig(num_disparities=D, census_window=(7, 9), dtype=dtype)
        sc = float_sgm if dtype == "float32" else bench_cfg[1]
        ms = cuda_ms(torch, lambda: two_view_disparity(*bench_pair, cc, sc), TIMED_FRAMES)
        emit({"phase": "timing", "metric": "two_view_ms_per_frame", "shape": [h, w, D],
              "dtype": dtype, "uniqueness": sc.uniqueness, "lr_max_diff": sc.lr_max_diff,
              "frames": TIMED_FRAMES, "ms_per_frame": ms, "mp_per_s": h * w / 1e6 / (ms / 1e3),
              **tag})
    cc = CostConfig(num_disparities=D, census_window=(7, 9), dtype="float32")
    plain_ms = cuda_ms(torch, lambda: two_view_disparity(*bench_pair, cc, float_sgm,
                                                         backend="torch"), PLAIN_FRAMES, warmup=1)
    emit({"phase": "timing", "metric": "two_view_ms_per_frame", "shape": [h, w, D],
          "dtype": "float32", "plain_frames": PLAIN_FRAMES, "plain_ms_per_frame": plain_ms, **tag})
    ms = cuda_ms(torch, lambda: array_depth_pipeline(images, cams, zncc_cfg), ARRAY_FRAMES)
    plain_ms = cuda_ms(torch, lambda: array_depth_pipeline(images, cams, zncc_cfg,
                                                           backend="torch"), 1, warmup=1)
    emit({"phase": "timing", "metric": "array_zncc_ms_per_frame_set", "run": "cross_zncc",
          "shape": [rows * cols, AH, AW, AD], "frames": ARRAY_FRAMES, "ms_per_frame_set": ms,
          "plain_frames": 1, "plain_ms_per_frame_set": plain_ms, **tag})
    ftotal = sgm_aggregate_float(fvol, fp2_y, fp2_x, 8.0)
    float_calls = {
        k6["name"]: lambda b: extract_disparity_maps(ftotal, True, 0.95, 1.5, b),
        k7["name"]: lambda b: sgm_aggregate_float(fvol, fp2_y, fp2_x, 8.0, 8, backend=b),
        **api_runs,
    }
    for k in float_kernels:
        call = float_calls[k["name"]]
        k["ms"] = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        k["device_ms"] = device_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        k["plain_ms"] = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": k["name"], "shape": [h, w, D], "dtype": "float32",
              "iters": TIMED_FRAMES, "ms": k["ms"], "device_ms": k["device_ms"],
              "plain_iters": PLAIN_FRAMES, "plain_ms": k["plain_ms"], **tag})
    # K7's strip route at the array's ZNCC shape, in its wdh order; bound as
    # K7's at the bench shape
    ah, aw, ad = 270, 360, 128
    _, _, avol, ap2_y, ap2_x = float_inputs(ah, aw, ad, seed=3)
    call = lambda b: sgm_aggregate_float(avol, ap2_y, ap2_x, 8.0, 8, order="wdh",  # noqa: E731
                                         backend=b)
    t_bytes = (ah * aw * ad * 8 + 2 * ah * aw * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = ah * aw * ad * (8 * 8 + 7) / F32_OPS_PER_S * 1e3
    k7["at_shapes"] = {"array_zncc": {
        "shape": [ah, aw, ad], "order": "wdh",
        "ms": cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
        "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
        "plain_ms": cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}}
    emit({"phase": "timing", "kernel": k7["name"], **k7["at_shapes"]["array_zncc"], **tag})
    del avol
    # K6 without the LR check (raw WTA, the wdh route): the right view is skipped
    call = lambda b: extract_disparity_maps(ftotal, True, 0.0, 0.0, b)  # noqa: E731
    emit({"phase": "timing", "kernel": k6["name"], "variant": "no_lr", "shape": [h, w, D],
          "dtype": "float32", "iters": TIMED_FRAMES, "ms": cuda_ms(torch, lambda: call("cuda"),
                                                                    TIMED_FRAMES),
          "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
          "plain_iters": PLAIN_FRAMES,
          "plain_ms": cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1), **tag})

    # one PyTorch library call computing the same function, where there is one
    rng = np.random.default_rng(2)
    disp_r = torch.from_numpy(rng.uniform(0, D - 1, (h, w)).astype(np.float32)).cuda()
    src_col = torch.from_numpy(rng.integers(0, w, (h, w))).cuda()
    values = torch.from_numpy(rng.uniform(0, 255, (1, 1, CH, CW)).astype(np.float32)).cuda()
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, CH, CW, 2)).astype(np.float32)).cuda()
    # (grid_sample, one channel on a random grid, computes no aux output: the
    # timed K9 case does)
    for k, name, fn in (
            (k5, "torch.gather", lambda: torch.gather(disp_r, 1, src_col)),
            (k9, "torch.nn.functional.grid_sample",
             lambda: torch.nn.functional.grid_sample(values, grid, "bilinear", "border",
                                                     align_corners=True))):
        k["library"] = (name, cuda_ms(torch, fn, TIMED_FRAMES), device_ms(torch, fn, TIMED_FRAMES))
        emit({"phase": "timing", "library": name, "for": k["name"], "iters": TIMED_FRAMES,
              "ms": k["library"][1], "device_ms": k["library"][2], **tag})

    # ---- 4e-6e. the served capture path --------------------------------------------
    import tempfile

    # the served frame-sets stay on disk for the CLI's `serve` (4g)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_served_")
    tmp = tmp_dir.name
    scene = served_scene(torch, tmp)
    served_counts = served_path(torch, counted, tag, *scene)
    for k in all_kernels:
        k["served_launches"] = served_counts[k["name"]]
    records(torch, tag)
    served_timing(torch, tag, *scene)

    # ---- 4f-6f. SfM and calibration: the calibrated rig's depth, the rectified pair -----
    sfm_state, calibrated_counts = calibration_paths(torch, counted, tag, bench_cfg)
    for k in all_kernels:
        k["calibrated_launches"] = calibrated_counts[k["name"]]
    calibration_records(tag, sfm_state)
    calibration_timing(torch, tag, sfm_state, bench_cfg, bench_pair)

    # ---- 4g-6g. the command line ---------------------------------------------------
    cli_scratch = Path(tmp) / "cli"
    cli_scratch.mkdir()
    cli_state = cli_paths(torch, counted, tag, cli_scratch, scene[2])
    for k in all_kernels:
        k["cli_launches"] = cli_state["totals"][k["name"]]
    cli_timing(torch, tag, cli_scratch, cli_state)
    tmp_dir.cleanup()

    # bound: the larger of the bytes the function must move (each input read
    # once, each output written once) over HBM bandwidth and its scalar
    # operations over the float32 peak, at the shape of each timing above.
    # Operations per element: K1 two per census word plus 14 for BT and the
    # store; K2/K3/K7-K12 8 per path step (neighbour and jump minima, P1 add,
    # two subtractions and adds) plus one add per path in a combine; K4/K6 6
    # per volume element (two views' compare and select, the second best);
    # K8 60 per pixel, plane and source (bilinear warp, 24 census compares
    # and packs, xor and popcount); K5 4 and K9 12 per pixel.
    HW, HWD = h * w, h * w * D
    bounds = {
        # K1 at the bench shape's int8 volume
        "K1 cost_volume": k1_bound(h, w, D, (7, 9), 1, as_ms=False),
        "K2/K3 sgm_paths": (HWD + 2 * HW * 2 + HWD * 2, 8 * HWD * 8),
        "K4 extract_maps": (HWD * 2 + HW * 17, HWD * 6),
        "K5 lr_gather": (HW * 12, HW * 4),
        # the fused launch: K4's bytes without the right map, K4's operations
        # and the LR test's 4 a pixel
        "K5 lr_check fused": (HWD * 2 + HW * 13, HWD * 6 + HW * 4),
        "K8 plane_sweep": (5 * AH * AW * 4 + 4 * AD * 8 + AH * AW * AD * 8,
                           4 * AH * AW * AD * 60),
        "K9 hat_sample": (CH * CW * 16 + CW * 4, CH * CW * 12),
        # values, t_rows, t_cols read, out written; 12 operations a pass
        "K9 hat_sample_2d": (int(np.prod(prewarp_shape)) * 16, int(np.prod(prewarp_shape)) * 24),
        k6["name"]: (HWD * 4 + HW * 13, HWD * 6 + HW * 4),
        k7["name"]: (HWD * 8 + 2 * HW * 4, 8 * HWD * 8 + 7 * HWD),
        # the sweep subset timed: 7 paths, 6 adds
        k7g["name"]: (HWD * 8 + 2 * HW * 4, 7 * HWD * 8 + 6 * HWD),
        k10["name"]: (HWD * 8 + HW * 4, 8 * HWD * 8 + 7 * HWD),
        k11["name"]: (HWD * 12 + HW * 4, 6 * HWD * 8 + 4 * HWD),
        k12["name"]: (HWD * 4 + 2 * HW * 4 + HW * 13, 8 * HWD * 8 + 13 * HWD),
        # the CROSS pass: reference, disparity, mask and 4 views read, four
        # outputs written; ~30 operations a view term of 11 offsets
        kr["name"]: (AH * AW * (4 * 6 + 1 + 13), 11 * 4 * AH * AW * 30),
    }
    for k in all_kernels:
        nbytes, ops = bounds[k["name"]]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        k["bound_ms"], k["bound_by"] = max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")

    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"],
                       "launches": (k["launches"] + k["array_launches"] + k["cascade_launches"]
                                    + k["float_launches"] + k["served_launches"]
                                    + k["calibrated_launches"] + k["cli_launches"]),
                       "launches_by_path": {"two_view": k["launches"],
                                            "array": k["array_launches"],
                                            "cascade": k["cascade_launches"],
                                            "float": k["float_launches"],
                                            "served": k["served_launches"],
                                            "calibrated": k["calibrated_launches"],
                                            "cli": k["cli_launches"]},
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                       "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                       "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                       "library_ms": k["library"][1] if "library" in k else None,
                       "library_device_ms": k["library"][2] if "library" in k else None,
                       "library_call": k["library"][0] if "library" in k else None,
                       **({"at_shapes": k["at_shapes"]} if "at_shapes" in k else {})}
                      for k in all_kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
