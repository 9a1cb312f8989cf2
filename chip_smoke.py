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

    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"], "launches": k["launches"],
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
                      for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
