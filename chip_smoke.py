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
The line before the last lists the kernels; the last line is the result.
Needs no network and no JAX.
"""

from __future__ import annotations

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
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype differ: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if torch.equal(a, b):
        return 0.0
    return (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()  # NaN if only NaNs differ


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
    ]
    for k in kernels:
        k["max_abs_err"] = 0.0

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

    cams, images, _ = array_scene(AH, AW)
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

    # ---- 4. main path --------------------------------------------------------
    bench_cfg = (CostConfig(num_disparities=64, census_window=(7, 9), dtype="int8"),
                 SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True))
    entry_cfg = (CostConfig(num_disparities=64, census_window=(7, 9)),
                 SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True))
    bench_pair = stereo_pair(torch, BENCH_SHAPE[0], BENCH_SHAPE[1], seed=0)
    entry_pair = stereo_pair(torch, ENTRY_SHAPE[0], ENTRY_SHAPE[1], seed=0, offset=16)
    for k in kernels:
        k["fn"].launches = 0
    outs = [two_view_disparity(*bench_pair, *bench_cfg),
            two_view_disparity(*entry_pair, *entry_cfg)]
    torch.cuda.synchronize()
    for k in kernels:
        k["launches"] = k["fn"].launches
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    for name, out, pair, cfg in (("bench", outs[0], bench_pair, bench_cfg),
                                 ("entry", outs[1], entry_pair, entry_cfg)):
        plain = two_view_disparity(*pair, *cfg, backend="torch")
        errs = {f: max_err(torch, getattr(out, f), getattr(plain, f))
                for f in ("disparity", "valid", "cost", "confidence")}
        h, w = pair[0].shape
        finite = bool(torch.isfinite(out.disparity).all() and torch.isfinite(out.cost).all())
        emit({"phase": "main_path", "run": name, "shape": [h, w, cfg[0].num_disparities],
              "dtype": cfg[0].dtype, "valid_fraction": out.valid.float().mean().item(),
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"main path ({name}) differs from the plain path or is not finite")
        if tuple(out.disparity.shape) != (h, w):
            fail(f"main path ({name}) disparity shape {tuple(out.disparity.shape)}")

    # ---- 4b. array main path -------------------------------------------------
    array_cfgs = {"cross": array_config(AD, **{"plane_sweep.topology": "CROSS"}),
                  "to_center": array_config(AD)}
    array_kernels = kernels + [k8]
    for k in array_kernels:
        k["fn"].launches = 0
    array_outs = {name: array_depth_pipeline(images, cams, cfg) for name, cfg in array_cfgs.items()}
    torch.cuda.synchronize()
    for k in array_kernels:
        k["array_launches"] = k["fn"].launches
    missing = [k["name"] for k in array_kernels
               if k["name"] in ("K8 plane_sweep", "K2/K3 sgm_paths", "K4 extract_maps")
               and k["array_launches"] == 0]
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
              "launches": {k["name"]: k["array_launches"] for k in array_kernels},
              "max_abs_err_vs_plain": errs, "finite": finite, **tag})
        if any(e != 0.0 for e in errs.values()) or not finite:
            fail(f"array path ({name}) differs from the plain path or is not finite")
        if tuple(out.refined_depth.shape) != (AH, AW):
            fail(f"array path ({name}) depth shape {tuple(out.refined_depth.shape)}")

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
            p_ms = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
            emit({"phase": "timing", "kernel": k["name"], "shape": [h, w, D], "dtype": dtype,
                  "iters": TIMED_FRAMES, "ms": k_ms, "plain_iters": PLAIN_FRAMES,
                  "plain_ms": p_ms, **tag})
            if dtype == "int8":  # the bench shape and dtype
                k["ms"], k["plain_ms"] = k_ms, p_ms

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
        p_ms = cuda_ms(torch, lambda: plane_sweep_census(*args, **fusion, backend="torch"),
                       PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": k8["name"], "run": name, "shape": [AH, AW, AD],
              "sources": args[1].shape[0], "iters": TIMED_FRAMES, "ms": k_ms,
              "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})
        k8[f"ms_{name}"], k8[f"plain_ms_{name}"] = k_ms, p_ms
    k8["ms"], k8["plain_ms"] = k8["ms_cross"], k8["plain_ms_cross"]
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
                    (kernels[2], lambda b: extract_maps(total, True, 0.0, b))):
        k_ms = cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES)
        p_ms = cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1)
        emit({"phase": "timing", "kernel": k["name"], "run": "array_cross",
              "shape": [AH, AW, AD], "dtype": "int8", "iters": TIMED_FRAMES, "ms": k_ms,
              "plain_iters": PLAIN_FRAMES, "plain_ms": p_ms, **tag})

    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"],
                       "launches": k["launches"] + k["array_launches"],
                       "launches_by_path": {"two_view": k["launches"],
                                            "array": k["array_launches"]},
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
                      for k in kernels + [k8]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
