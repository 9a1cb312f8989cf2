#!/usr/bin/env python3
"""Where K2/K3 (the integer SGM scans) and K8 (the plane sweep) of a checkout
whose K2/K3 adds into an int32 total with atomics spend their device time.

    python3 scripts/perf_scan_sweep_variants.py --package-root DIR --variants FILE.cu

DIR is such a checkout, unpacked (the port up to its sixth slice). FILE.cu is
a scratch copy of that checkout's two kernels (kept out of the repo) that
exports

    svt_probe_sgm(cost, cost_bytes, p2_y, p2_x, total32, h, w, D, p1, num_paths,
                  variant, stream)
    svt_probe_sweep(ref, src, shifts, fused, nviews, n_src, h, w, D, patch, mode,
                    topk, variant, stream)

with one thing changed per variant: K2/K3 0 as is, 1 atomicAdd replaced by a
plain store, 2 the costs and P2 of the next pixel loaded a step ahead, 3 both;
K8 0 as is, 1 the warped window staged but no census (a read of the centre
instead), 2 the window staged once a block and the census and fusion for
every plane and source. Times, as device ms of 20 launches queued behind a
GPU spin: K2/K3's wrapper, its kernel alone, the torch.zeros of the int32
total and its narrowing .to(int16), at 540x768x64, 540x768x256 and
270x360x128 (int8 costs, 8 paths); K8 at CROSS and to_center (270x360x128).
Writes ptxas's register report of both sources and chiprun_out/step1.json.
Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
ap = argparse.ArgumentParser()
ap.add_argument("--package-root", type=Path, required=True)
ap.add_argument("--variants", type=Path, required=True)
ARGS = ap.parse_args()
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(ARGS.package_root.resolve()))
import chip_smoke  # noqa: E402
from chip_smoke import cuda_ms, device_ms  # noqa: E402
from stereovisionarray_tpu_torch import _native, config  # noqa: E402
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda  # noqa: E402
from stereovisionarray_tpu_torch.ops.sgm import p2_maps  # noqa: E402
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_paths  # noqa: E402
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census  # noqa: E402
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array  # noqa: E402
from stereovisionarray_tpu_torch.geometry import inverse_depth_samples  # noqa: E402
from stereovisionarray_tpu_torch.models.array_pipeline import reference_and_sources  # noqa: E402
from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts  # noqa: E402

OUT = REPO / "chiprun_out"
OUT.mkdir(exist_ok=True)
card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
lines = []


def emit(o):
    o = {**o, "card": card}
    lines.append(o)
    print(json.dumps(o), flush=True)


emit({"torch": torch.__version__, "cuda": torch.version.cuda})
_native.timed_build()
nvcc = _native.nvcc_path()
bdir = _native.BUILD_DIR / "probe"
bdir.mkdir(exist_ok=True)
for src in ("sgm_paths.cu", "plane_sweep.cu"):
    r = subprocess.run([nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(bdir / (src + ".o")),
                        str(_native.CSRC_DIR / src)],
                       capture_output=True, text=True)
    (OUT / f"ptxas_{src}.txt").write_text(r.stdout + r.stderr)
r = subprocess.run([nvcc, *_native.NVCC_FLAGS, "-shared", "-o", str(bdir / "libprobe.so"),
                    str(ARGS.variants.resolve())], capture_output=True, text=True)
if r.returncode:
    print(r.stdout, r.stderr)
    raise SystemExit(1)
lib = ctypes.CDLL(str(bdir / "libprobe.so"))
P, I = ctypes.c_void_p, ctypes.c_int
lib.svt_probe_sgm.argtypes = (P, I, P, P, P, I, I, I, I, I, I, P)
lib.svt_probe_sweep.argtypes = (P, P, P, P, P, I, I, I, I, I, I, I, I, P)


def stream():
    return torch.cuda.current_stream().cuda_stream


ITERS = 20
sgm_cfg = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True)
for (h, w, D) in ((540, 768, 64), (540, 768, 256), (270, 360, 128)):
    left, right = chip_smoke.stereo_pair(torch, h, w, seed=0)
    vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, "int8")
    p2_y, p2_x = p2_maps((h, w), 96, torch.int16, left.device, left, True, 24)
    total = torch.zeros((h, w, D), dtype=torch.int32, device="cuda")
    res = {"shape": [h, w, D], "dtype": "int8", "num_paths": 8}
    res["wrapper_ms"] = cuda_ms(torch, lambda: sgm_aggregate_paths(vol, p2_y, p2_x, 8, 8), ITERS)
    res["wrapper_device_ms"] = device_ms(torch, lambda: sgm_aggregate_paths(vol, p2_y, p2_x, 8, 8), ITERS)
    res["zeros_device_ms"] = device_ms(torch, lambda: torch.zeros((h, w, D), dtype=torch.int32, device="cuda"), ITERS)
    res["narrow_device_ms"] = device_ms(torch, lambda: total.to(torch.int16), ITERS)
    for v, name in ((0, "kernel_atomic"), (1, "kernel_store"), (2, "kernel_prefetch_atomic"),
                    (3, "kernel_prefetch_store")):
        fn = lambda: lib.svt_probe_sgm(vol.data_ptr(), 1, p2_y.data_ptr(), p2_x.data_ptr(),  # noqa: E731
                                       total.data_ptr(), h, w, D, 8, 8, v, stream())
        res[name + "_device_ms"] = device_ms(torch, fn, ITERS)
    # the parent's kernel alone through its own entry point
    fn = lambda: _native.launch("svt_sgm_paths", vol.device, vol.data_ptr(), 1, p2_y.data_ptr(),  # noqa: E731
                                p2_x.data_ptr(), total.data_ptr(), h, w, D, 8, 8)
    res["kernel_alone_device_ms"] = device_ms(torch, fn, ITERS)
    # the plain-store variant's output is racy; check the prefetch+atomic variant is right
    ref_total = torch.zeros_like(total)
    fn2 = torch.zeros_like(total)
    _native.launch("svt_sgm_paths", vol.device, vol.data_ptr(), 1, p2_y.data_ptr(),
                   p2_x.data_ptr(), ref_total.data_ptr(), h, w, D, 8, 8)
    lib.svt_probe_sgm(vol.data_ptr(), 1, p2_y.data_ptr(), p2_x.data_ptr(), fn2.data_ptr(),
                      h, w, D, 8, 8, 2, stream())
    torch.cuda.synchronize()
    res["prefetch_atomic_equal"] = bool(torch.equal(ref_total, fn2))
    emit({"probe": "k2k3", **res})
    del total, ref_total, fn2

rows, cols, AH, AW, AD = chip_smoke.ARRAY_SHAPE
cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(AH, AW))
images, _ = render_camera_array(cams, (AH, AW))
images = torch.from_numpy(images).cuda()
for name, over in (("cross", {"plane_sweep.topology": "CROSS"}), ("to_center", {})):
    cfg = config.EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                            "plane_sweep.num_planes": AD, **over})
    ps = cfg.plane_sweep
    ref_index, src = reference_and_sources(cfg, images.shape[0])
    depths = inverse_depth_samples(ps.z_near, ps.z_far, ps.num_planes)
    shifts = torch.from_numpy(np.ascontiguousarray(
        translation_shifts(cams, ref_index, src, depths).swapaxes(0, 1))).cuda()
    topk = ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None
    ref = images[ref_index].contiguous()
    srcs = images[list(src)].contiguous()
    S = len(src)
    mode = 2 if topk else (1 if ps.fusion == "mean" else 0)
    fused = torch.empty((AH, AW, AD), device="cuda")
    nv = torch.empty((AH, AW, AD), dtype=torch.int32, device="cuda")
    res = {"case": name, "sources": S, "topk": topk, "patch": ps.patch,
           "shift_range": [float(shifts[..., 0].min()), float(shifts[..., 0].max()),
                           float(shifts[..., 1].min()), float(shifts[..., 1].max())]}
    call = lambda: plane_sweep_census(ref, srcs, shifts, ps.patch, ps.fusion == "mean", topk)  # noqa: E731
    res["wrapper_ms"] = cuda_ms(torch, call, ITERS)
    res["wrapper_device_ms"] = device_ms(torch, call, ITERS)
    for v, vname in ((0, "parent"), (1, "staging_only"), (2, "census_only")):
        fn = lambda: lib.svt_probe_sweep(ref.data_ptr(), srcs.data_ptr(), shifts.data_ptr(),  # noqa: E731
                                         fused.data_ptr(), nv.data_ptr(), S, AH, AW, AD, ps.patch,
                                         mode, topk or 0, v, stream())
        res[vname + "_device_ms"] = device_ms(torch, fn, ITERS)
    emit({"probe": "k8", **res})
(OUT / "step1.json").write_text(json.dumps(lines, indent=1))
