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
        array_depth_pipeline,
        reference_and_sources,
    )
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
    all_kernels = kernels + [k8, k9, k9_2d] + float_kernels
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
    array_kernels = [k8["name"], "K2/K3 sgm_paths", "K4 extract_maps"]
    missing = [n for n in array_kernels if arr_counts[n] == 0]
    if missing:
        fail(f"the array path never launched {missing}")
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
                       [k7["name"], k6["name"]],
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
    }
    for k in all_kernels:
        nbytes, ops = bounds[k["name"]]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        k["bound_ms"], k["bound_by"] = max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")

    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"],
                       "launches": (k["launches"] + k["array_launches"] + k["cascade_launches"]
                                    + k["float_launches"]),
                       "launches_by_path": {"two_view": k["launches"],
                                            "array": k["array_launches"],
                                            "cascade": k["cascade_launches"],
                                            "float": k["float_launches"]},
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
