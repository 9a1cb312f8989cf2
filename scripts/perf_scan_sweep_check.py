#!/usr/bin/env python3
"""K2/K3 and K8 on an NVIDIA GPU: parity and device times at the main paths'
shapes, and the host side of the paths around them.

    python3 scripts/perf_scan_sweep_check.py [--cascade-host] [--waits]

Default: builds the kernels (and writes ptxas's register report of both
sources to chiprun_out/), then for K2/K3 at 540x768x64 (int8, int16),
540x768x256, 270x360x128, 541x766x48 (4 paths) and 541x766x97, and for K8 at
270x360x128 (CROSS, to_center, valid mean, patch 3 and 7) and 271x361x97,
prints one JSON line each: equal to the plain twin (max_abs_err), wrapper ms
(CUDA events) and device ms (20 launches behind a GPU spin).
--cascade-host: the two-view cascade at chip_smoke.py's configuration, its
wall and device ms, the host cost of handing its resize tables to the card,
and a profiler table of its CPU and CUDA time (chiprun_out/cascade_profile.txt).
--waits: for resize_linear, the two-view cascade and the array pipeline
(flat and cascade) at a small size, the first Python call after which a
~2 s GPU spin had ended while the call was still enqueueing (the host waited
there), from a sys.setprofile hook. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from chip_smoke import cuda_ms, device_ms  # noqa: E402
from stereovisionarray_tpu_torch import _native, backend, config  # noqa: E402
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array  # noqa: E402
from stereovisionarray_tpu_torch.geometry import inverse_depth_samples  # noqa: E402
from stereovisionarray_tpu_torch.models import array_depth_pipeline, cascade, cascade_two_view_disparity  # noqa: E402
from stereovisionarray_tpu_torch.models.array_pipeline import reference_and_sources  # noqa: E402
from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts  # noqa: E402
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda  # noqa: E402
from stereovisionarray_tpu_torch.ops.sgm import p2_maps  # noqa: E402
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_paths  # noqa: E402
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census  # noqa: E402

OUT = REPO / "chiprun_out"
CARD = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def emit(obj):
    print(json.dumps({**obj, "card": CARD}), flush=True)


def kernels():
    emit({"build_s": _native.timed_build()})
    OUT.mkdir(exist_ok=True)
    for src in ("sgm_paths.cu", "plane_sweep.cu"):
        r = subprocess.run([_native.nvcc_path(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                            str(_native.BUILD_DIR / (src + ".o")), str(_native.CSRC_DIR / src)],
                           capture_output=True, text=True)
        (OUT / f"ptxas_{src}.txt").write_text(r.stdout + r.stderr)
    for h, w, D, dt, paths in ((540, 768, 64, "int8", 8), (540, 768, 64, "int16", 8),
                               (540, 768, 256, "int8", 8), (270, 360, 128, "int8", 8),
                               (541, 766, 48, "int8", 4), (541, 766, 97, "int16", 8)):
        left, right = chip_smoke.stereo_pair(torch, h, w, seed=h + D)
        vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, dt)
        p2_y, p2_x = p2_maps((h, w), 96, torch.int16, left.device, left, True, 24)
        call = lambda b="auto": sgm_aggregate_paths(vol, p2_y, p2_x, 8, paths, b)  # noqa: E731
        got, want = call(), call("torch")
        emit({"kernel": "K2/K3", "shape": [h, w, D], "dtype": dt, "paths": paths,
              "max_abs_err": float((got.int() - want.int()).abs().max()),
              "ms": cuda_ms(torch, call, 20), "device_ms": device_ms(torch, call, 20)})
    for h, w, D, over in ((270, 360, 128, {"plane_sweep.topology": "CROSS"}), (270, 360, 128, {}),
                          (270, 360, 128, {"plane_sweep.fusion": "mean"}),
                          (270, 360, 128, {"plane_sweep.topology": "CROSS", "plane_sweep.patch": 3}),
                          (270, 360, 128, {"plane_sweep.topology": "CROSS", "plane_sweep.patch": 7}),
                          (271, 361, 97, {})):
        cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(h, w))
        images = torch.from_numpy(render_camera_array(cams, (h, w))[0]).cuda()
        cfg = config.EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                                "plane_sweep.num_planes": D, **over})
        ps = cfg.plane_sweep
        ref_index, src = reference_and_sources(cfg, images.shape[0])
        depths = inverse_depth_samples(ps.z_near, ps.z_far, ps.num_planes)
        shifts = torch.from_numpy(np.ascontiguousarray(
            translation_shifts(cams, ref_index, src, depths).swapaxes(0, 1))).cuda()
        topk = ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None
        ref, srcs = images[ref_index].contiguous(), images[list(src)].contiguous()
        call = lambda b="auto": plane_sweep_census(ref, srcs, shifts, ps.patch,  # noqa: E731
                                                   ps.fusion == "mean", topk, b)
        got, want = call(), call("torch")
        emit({"kernel": "K8", "shape": [h, w, D], "sources": len(src), "patch": ps.patch,
              "topk": topk, "fusion": ps.fusion,
              "max_abs_err": max(float((a.double() - b.double()).abs().max())
                                 for a, b in zip(got, want)),
              "ms": cuda_ms(torch, call, 20), "device_ms": device_ms(torch, call, 20)})


def cascade_host():
    left, right, _, _ = chip_smoke.two_view_cascade_scene(torch, torch.device("cuda", 0))
    run = lambda: chip_smoke.two_view_cascade_run(left, right)  # noqa: E731
    emit({"run": "two_view_cascade", "wall_ms": cuda_ms(torch, run, 20),
          "device_ms": device_ms(torch, run, 5)})  # None: the host never got ahead of the spin
    w1, w2 = cascade._linear_resize_weights(135, 540), cascade._linear_resize_weights(192, 768)
    t0 = time.perf_counter()
    for _ in range(100):
        backend.host_to_device(w1, left.device)
        backend.host_to_device(w2, left.device)
    emit({"host_to_device_resize_tables_us": (time.perf_counter() - t0) / 100 * 1e6})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "cascade_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))


def waits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 60, (34, 48)).astype(np.float32)).cuda()
    img = np.floor(rng.uniform(0, 256, (48, 168))).astype(np.float32)
    left, right = torch.from_numpy(img[:, :128]).cuda(), torch.from_numpy(img[:, 40:]).cuda()
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(45, 60))
    images = torch.from_numpy(render_camera_array(cams, (45, 60))[0]).cuda()
    cfg = config.EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                            "plane_sweep.num_planes": 32,
                                            "plane_sweep.topology": "CROSS"})
    ccfg = cfg.override(**{"plane_sweep.num_planes": 64, "plane_sweep.cascade": True,
                           "plane_sweep.cascade_fine_planes": 24})
    runs = {"resize_linear": lambda: cascade.resize_linear(x, (136, 192)),
            "two_view_cascade": lambda: cascade_two_view_disparity(
                left, right, config.CostConfig(num_disparities=64, dtype="int8"),
                config.SGMConfig(num_paths=8), 4, 16, 8),
            "array": lambda: array_depth_pipeline(images, cams, cfg),
            "array_cascade": lambda: array_depth_pipeline(images, cams, ccfg)}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 32)
        ev = torch.cuda.Event()
        ev.record()
        trail, flip = [], {}

        def hook(frame, event, arg):
            if flip:
                return
            where = f"{Path(frame.f_code.co_filename).name}:{frame.f_lineno} {frame.f_code.co_name}"
            if ev.query():
                flip.update(at=where, event=event, trail=trail[-12:])
            else:
                trail.append(f"{where} {event}")

        sys.setprofile(hook)
        try:
            fn()
        finally:
            sys.setprofile(None)
        torch.cuda.synchronize()
        emit({"run": name, "waited_at": flip or None})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cascade-host", action="store_true")
    ap.add_argument("--waits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perf_scan_sweep_check: needs a CUDA device")
    kernels()
    if args.cascade_host:
        cascade_host()
    if args.waits:
        waits()


if __name__ == "__main__":
    main()
