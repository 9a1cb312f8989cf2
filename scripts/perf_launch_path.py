#!/usr/bin/env python3
"""Where a small kernel's wrapper call spends its time on an NVIDIA GPU.

    python3 scripts/perf_launch_path.py [--calls 1000] [--kernels] [--e2e]
        [--package-root DIR --tag NAME]

For the hat sampler K9 (the two-view cascade's residual warp, 540x768 with
its aux table) and the standalone LR gather K5 (540x768, D=64), times each
step of one wrapper call with ``time.perf_counter_ns`` over ``--calls``
calls, without synchronising:

 - ``resolve_backend``;
 - the argument checks;
 - the output allocations (``torch.empty``);
 - the device context and stream lookup;
 - the lookup of the C entry point;
 - the ctypes call itself (which enqueues the kernel), and the same call
   refused by the entry point's own argument check before any launch (a
   batch of 0), which is ctypes' share of it;
 - the whole wrapper call.

Each step is timed in the form the launch path of the port's first four
slices took (``pr4_*``: a ``torch.cuda.device`` context, a
``torch.cuda.current_stream`` object, ``getattr`` on the library, shape
tuples rebuilt for every check, ``torch.empty`` with a dtype and a device)
and, where the checkout has them, in the forms of the lean launch path in
``_native.py`` (``lean_*``). ``wrapper`` is the checkout's own wrapper: run
the script from an unpacked older checkout to time that one's. ``loop`` is
the cost of the timing loop and the closure call alone.

Then each kernel's device time: ``--device-iters`` launches queued behind a
``torch.cuda._sleep`` spin, so that the two CUDA events bracket the device's
work and none of the host's (the spin is lengthened until the host has
enqueued every launch before it ends). The same for the PyTorch call that
computes the same function (``torch.gather``, ``grid_sample``).

With ``--kernels``, every kernel's device time at the main paths' shapes
(the same spin), on inputs made from a seed: K1 at every shape a path gives
it (``chip_smoke.K1_ROWS``, each line naming the kernel form that ran), K2/K3
at 540x768x64 int8 and int16, 540x768x256 and 270x360x128, K8 at CROSS and
to_center, K9 beside them, K7 at 540x768x64 (k7 order) and 270x360x128
(wdh), whole and its generic form's walks and combine apart (and each kernel
of the whole call from ``torch.profiler``), K10-K12 at 540x768x64, and the extraction
K4 / K6 at every shape, volume type and LR setting a path gives it
(``chip_smoke.EXTRACT_ROWS``; each line names the kernel form that ran,
where the checkout's ``ops/extract_cuda`` has a tile plan). With ``--e2e``,
the end-to-end times of the paths, CUDA events over warm frames as
``chip_smoke.py`` times them: two-view at 540x768x64 (int8, int16, float32
with uniqueness and LR), the flat two-view at 540x768x256 and its cascade,
the array (5x5 of 270x360, 128 planes) at CROSS, to_center, CROSS with ZNCC
costs and its cascade; for the two-view paths also the frame's device time
(the frames queued behind a GPU spin, free of the host's pace).

``--package-root DIR`` imports the package from another checkout (an
unpacked older commit), so that two versions compare within one call, in
turns. Prints one JSON line per measurement and writes them all to
``chiprun_out/perf_launch_path[_TAG].json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from chip_smoke import cuda_ms, device_ms  # noqa: E402


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def host_ns(fn, calls: int) -> float:
    """Mean host nanoseconds of one fn() over `calls` calls, unsynchronised."""
    for _ in range(10):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    return (time.perf_counter_ns() - t0) / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--device-iters", type=int, default=200)
    ap.add_argument("--e2e", action="store_true", help="also time the paths end to end")
    ap.add_argument("--kernels", action="store_true",
                    help="also time every kernel's device time at the main paths' shapes")
    ap.add_argument("--package-root", type=Path, default=REPO,
                    help="checkout whose stereovisionarray_tpu_torch to time")
    ap.add_argument("--tag", default="", help="suffix of the output file and label of each line")
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_launch_path: needs a CUDA device")
    from stereovisionarray_tpu_torch import _native
    from stereovisionarray_tpu_torch.backend import resolve_backend
    from stereovisionarray_tpu_torch.models.cascade import SMOOTH_R
    from stereovisionarray_tpu_torch.ops import hatsample
    from stereovisionarray_tpu_torch.ops.extract_cuda import lr_gather

    card = card_line()
    lines = []

    def emit(obj):
        obj = {**obj, "tag": args.tag, "card": card}
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "raw_stream_getter": hasattr(torch._C, "_cuda_getCurrentRawStream"),
          "device_getter": hasattr(torch._C, "_cuda_getDevice")})
    lib = _native.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    H, W, D, R = 540, 768, 64, SMOOTH_R

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    values = cuda(rng.uniform(0, 255, (H, W)).astype(np.float32))
    t = cuda(rng.uniform(-R - 1.5, R + 1.5, (H, W)).astype(np.float32))
    aux = cuda(rng.uniform(0, 200, W).astype(np.float32))
    disp_l = cuda(rng.uniform(0, D - 1, (H, W)).astype(np.float32))
    disp_r = cuda(rng.uniform(0, D - 1, (H, W)).astype(np.float32))
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    aout = torch.empty((H, W), dtype=torch.float32, device=dev)

    def pr4_validate(values, t, k0, k1, aux, axis):
        """hat_sample's argument checks of the port's first four slices."""
        if values.dim() not in (2, 3) or t.shape != values.shape:
            raise ValueError("values and t must share a shape")
        if axis not in (-1, -2):
            raise ValueError("bad axis")
        if k0 > k1:
            raise ValueError("empty tap range")
        if aux is not None and (axis != -1 or tuple(aux.shape) != (values.shape[-1],)):
            raise ValueError("bad aux")

    def pr4_check(x, name, dtype, shape):
        """The argument check of the port's first four slices."""
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def pr4_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    stream = pr4_stream()
    k9_args = (values.data_ptr(), t.data_ptr(), aux.data_ptr(), out.data_ptr(), aout.data_ptr(),
               1, H, W, -R, R, 0)
    k5_args = (disp_l.data_ptr(), disp_r.data_ptr(), out.data_ptr(), H, W, D)
    f32 = dict(dtype=torch.float32, device=dev)
    cases = {
        "K9 hat_sample": {
            "resolve_backend": lambda: resolve_backend(values, "auto"),
            "pr4_checks": lambda: (pr4_validate(values, t, -R, R, aux, -1),
                                   pr4_check(values, "values", torch.float32, (H, W)),
                                   pr4_check(t, "t", torch.float32, (H, W)),
                                   pr4_check(aux, "aux", torch.float32, (W,))),
            "pr4_allocations": lambda: (torch.empty((H, W), **f32),
                                        torch.empty((H, W), **f32)),
            "pr4_device_and_stream": pr4_stream,
            "pr4_entry_lookup": lambda: getattr(lib, "svt_hat_sample"),
            "ctypes_call": lambda: lib.svt_hat_sample(*k9_args, stream),
            "ctypes_call_refused": lambda: lib.svt_hat_sample(*k9_args[:5], 0, *k9_args[6:],
                                                              stream),
            "wrapper": lambda: hatsample.hat_sample(values, t, -R, R, aux=aux),
        },
        "K5 lr_gather": {
            "resolve_backend": lambda: resolve_backend(disp_l, "auto"),
            "pr4_checks": lambda: (pr4_check(disp_l, "disp_l", torch.float32, (H, W)),
                                   pr4_check(disp_r, "disp_r", torch.float32, (H, W))),
            "pr4_allocations": lambda: torch.empty((H, W), **f32),
            "pr4_device_and_stream": pr4_stream,
            "pr4_entry_lookup": lambda: getattr(lib, "svt_lr_gather"),
            "ctypes_call": lambda: lib.svt_lr_gather(*k5_args, stream),
            "ctypes_call_refused": lambda: lib.svt_lr_gather(*k5_args[:3], 0, *k5_args[4:],
                                                             stream),
            "wrapper": lambda: lr_gather(disp_l, disp_r, D),
        },
    }
    if hasattr(_native, "_FNS"):  # the lean launch path
        _native.library()
        fns, index = _native._FNS, dev.index

        def lean_stream():
            if torch._C._cuda_getDevice() == index:
                return torch._C._cuda_getCurrentRawStream(index)
            raise SystemExit("perf_launch_path: device 0 is not the current device")

        cases["K9 hat_sample"].update({
            "lean_checks": lambda: (hatsample._validate(values, t, -R, R, aux, -1),
                                    _native.check(values, "values", torch.float32, (H, W)),
                                    _native.check(t, "t", torch.float32, (H, W)),
                                    _native.check(aux, "aux", torch.float32, (W,))),
            "lean_allocations": lambda: (torch.empty_like(t), torch.empty_like(t)),
            "lean_device_and_stream": lean_stream,
            "lean_entry_lookup": lambda: fns["svt_hat_sample"],
        })
        cases["K5 lr_gather"].update({
            "lean_checks": lambda: (_native.check(disp_l, "disp_l", torch.float32, (H, W)),
                                    _native.check(disp_r, "disp_r", torch.float32, (H, W))),
            "lean_allocations": lambda: torch.empty_like(disp_l),
            "lean_device_and_stream": lean_stream,
            "lean_entry_lookup": lambda: fns["svt_lr_gather"],
        })
    loop_ns = host_ns(lambda: None, args.calls)
    emit({"step": "loop", "ns": loop_ns, "calls": args.calls})
    for kernel, steps in cases.items():
        for step, fn in steps.items():
            ns = host_ns(fn, args.calls)
            torch.cuda.synchronize()
            emit({"kernel": kernel, "step": step, "ns": ns, "calls": args.calls})
        emit({"kernel": kernel, "step": "device",
              "ms": device_ms(torch, steps["ctypes_call"], args.device_iters),
              "iters": args.device_iters})

    src_col = cuda(rng.integers(0, W, (H, W)))
    grid_values = values[None, None]
    grid = cuda(rng.uniform(-1, 1, (1, H, W, 2)).astype(np.float32))
    library = {
        "torch.gather": lambda: torch.gather(disp_r, 1, src_col),
        "grid_sample": lambda: torch.nn.functional.grid_sample(
            grid_values, grid, "bilinear", "border", align_corners=True),
    }
    for name, fn in library.items():
        ns = host_ns(fn, args.calls)
        torch.cuda.synchronize()
        emit({"library": name, "host_ns": ns,
              "device_ms": device_ms(torch, fn, args.device_iters), "iters": args.device_iters})

    if args.kernels:
        kernel_device_times(torch, emit)
    if args.e2e:
        e2e(torch, emit)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = f"perf_launch_path_{args.tag}.json" if args.tag else "perf_launch_path.json"
    (out_dir / name).write_text(json.dumps(lines, indent=1))


def kernel_device_times(torch, emit, iters: int = 20) -> None:
    """Device ms of every kernel wrapper at the main paths' shapes, on one
    set of inputs made from a seed (the same in every checkout): K1 at every
    ``chip_smoke.K1_ROWS`` shape, K2/K3 at 540x768x64 int8 and int16, at the
    flat cascade's 540x768x256 and at the array's 270x360x128, K7, the
    extraction rows (K4, K4 with the fused LR check, K6), K8 at CROSS and
    to_center, K9 and its 2-D form."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
    from stereovisionarray_tpu_torch.models.array_pipeline import reference_and_sources
    from stereovisionarray_tpu_torch.models.cascade import SMOOTH_R
    from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.extract_cuda import extract_disparity_maps, extract_maps
    from stereovisionarray_tpu_torch.ops.hatsample import hat_sample, hat_sample_2d
    from stereovisionarray_tpu_torch.ops.sgm import p2_maps
    from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float, sgm_aggregate_paths
    from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census

    def timed(name, fn, **info):
        emit({"kernel": name, **info, "device_ms": device_ms(torch, fn, iters), "iters": iters})

    rng = np.random.default_rng(0)
    h, w, D = chip_smoke.BENCH_SHAPE
    left, right = chip_smoke.stereo_pair(torch, h, w, seed=0)
    # K1 at every shape a path gives it (chip_smoke.K1_ROWS; each line names
    # the kernel form that ran, where the checkout's ops/cost_cuda has a plan)
    from stereovisionarray_tpu_torch.ops import cost_cuda

    cost_plan = getattr(cost_cuda, "_tile_plan", None)  # absent before the tiled kernel
    for row, (hh, ww, dd), window, dtype in chip_smoke.K1_ROWS:
        if row.startswith("generic"):
            continue
        lo, ro = chip_smoke.stereo_pair(torch, hh, ww, seed=hh + dd, integer=dtype == "int8")
        form = None
        if cost_plan is not None:
            size = chip_smoke.ELEMENT_BYTES[dtype]
            form = "tiled" if cost_plan(hh, ww, dd, window, size) else "generic"
        timed("K1 cost_volume", lambda: fused_cost_volume_cuda(lo, ro, dd, window, 0.25, 32.0,
                                                               dtype),
              row=row, shape=[hh, ww, dd], dtype=dtype, form=form)
    for shape, dtype in (((h, w, 64), "int8"), ((h, w, 64), "int16"), ((h, w, 256), "int8"),
                         ((270, 360, 128), "int8")):
        hh, ww, dd = shape
        lo, ro = chip_smoke.stereo_pair(torch, hh, ww, seed=1)
        vol = fused_cost_volume_cuda(lo, ro, dd, (7, 9), 0.25, 32.0, dtype)
        py, px = p2_maps((hh, ww), 96, torch.int16, lo.device, lo, True, 24)
        timed("K2/K3 sgm_paths", lambda: sgm_aggregate_paths(vol, py, px, 8, 8), shape=list(shape),
              dtype=dtype)
        del vol
    fvol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, "float32")
    fy, fx = p2_maps((h, w), 96.0, torch.float32, left.device, left, True, 24.0)
    timed("K7 sgm_float", lambda: sgm_aggregate_float(fvol, fy, fx, 8.0, 8), shape=[h, w, D])
    del fvol
    k7_device_times(torch, timed, emit, iters)

    # K4 / K6 at every shape, volume type and LR setting a path gives them
    from stereovisionarray_tpu_torch.ops import extract_cuda

    plan = getattr(extract_cuda, "_tile_plan", None)  # absent before the tiled kernel
    for row, kernel, (hh, ww, dd), vtype, lr in chip_smoke.EXTRACT_ROWS:
        vol = chip_smoke.extraction_volume(torch, hh, ww, dd, vtype)
        call = chip_smoke.extraction_call(extract_maps, extract_disparity_maps, kernel, vol, lr)
        name = {"K4": "K4 extract_maps", "K6": "K6 extract_volume"}[kernel] + (
            " + K5 fused" if lr and kernel == "K4" else "")
        form = None
        if plan is not None:
            form = "tiled" if plan(ww, dd, vol.element_size(), lr, lr).tiled else "generic"
        timed(name, lambda: call("cuda"), row=row, shape=[hh, ww, dd], dtype=vtype, lr=lr,
              form=form)
        del vol

    rows, cols, AH, AW, AD = chip_smoke.ARRAY_SHAPE
    cams, images, _, _ = chip_smoke.array_cascade_scene(torch, left.device)
    for name, over in (("cross", {"plane_sweep.topology": "CROSS"}), ("to_center", {})):
        cfg = config.EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                                "plane_sweep.num_planes": AD, **over})
        ps = cfg.plane_sweep
        ref_index, src = reference_and_sources(cfg, images.shape[0])
        depths = inverse_depth_samples(ps.z_near, ps.z_far, ps.num_planes)
        shifts = torch.from_numpy(np.ascontiguousarray(
            translation_shifts(cams, ref_index, src, depths).swapaxes(0, 1))).to(left.device)
        topk = ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None
        ref, srcs = images[ref_index].contiguous(), images[list(src)].contiguous()
        timed("K8 plane_sweep", lambda: plane_sweep_census(ref, srcs, shifts, ps.patch,
                                                           ps.fusion == "mean", topk),
              run=name, shape=[AH, AW, AD], sources=len(src))
    values = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(left.device)
    t = torch.from_numpy(rng.uniform(-SMOOTH_R - 1.5, SMOOTH_R + 1.5, (h, w))
                         .astype(np.float32)).to(left.device)
    aux = torch.from_numpy(rng.uniform(0, 200, w).astype(np.float32)).to(left.device)
    timed("K9 hat_sample", lambda: hat_sample(values, t, -SMOOTH_R, SMOOTH_R, aux=aux),
          shape=[h, w])
    v3 = torch.from_numpy(rng.uniform(0, 255, (4, AH, AW)).astype(np.float32)).to(left.device)
    t3 = torch.from_numpy(rng.uniform(-40, 40, (4, AH, AW)).astype(np.float32)).to(left.device)
    timed("K9 hat_sample_2d", lambda: hat_sample_2d(v3, t3, t3, -38, 38), shape=[4, AH, AW])


def profiled_kernel_ms(torch, fn, iters: int) -> dict:
    """Device ms a call of each CUDA kernel that fn() launches, from
    ``torch.profiler`` over `iters` warm calls: {kernel name: ms}, empty if
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            out[e.key] = us / 1e3 / iters
    return out


def k7_device_times(torch, timed, emit, iters: int) -> None:
    """K7 at the float paths' shapes: 540x768x64 in the k7 order (two-view
    float32) and 270x360x128 in the wdh order (the array's ZNCC path), 8
    paths, the whole call and the generic form's two launches apart (the
    walks into 8 partials, then the ordered combine), each behind a GPU spin,
    and every kernel of the whole call from the profiler; then K10, K11 and
    K12 at 540x768x64."""
    from stereovisionarray_tpu_torch.ops import sgm_cuda
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.sgm import ALL_SWEEPS, p2_maps, sweep_paths

    ids = [p for s in ALL_SWEEPS for p in sweep_paths(8)[s]]
    for (hh, ww, dd), order in ((chip_smoke.BENCH_SHAPE, "k7"), ((270, 360, 128), "wdh")):
        lo, ro = chip_smoke.stereo_pair(torch, hh, ww, seed=dd)
        vol = fused_cost_volume_cuda(lo, ro, dd, (7, 9), 0.25, 32.0, "float32")
        py, px = p2_maps((hh, ww), 96.0, torch.float32, lo.device, lo, True, 24.0)
        info = dict(shape=[hh, ww, dd], order=order, num_paths=8)
        call = lambda: sgm_cuda.sgm_aggregate_float(vol, py, px, 8.0, 8, order=order)  # noqa: E731
        timed("K7 sgm_float", call, **info)
        emit({"kernel": "K7 sgm_float", **info,
              "profiled_ms": profiled_kernel_ms(torch, call, iters)})
        partial, mask = sgm_cuda._float_partials(vol, py, px, 8.0, ids)
        timed("K7 generic walks", lambda: sgm_cuda._float_partials(vol, py, px, 8.0, ids), **info)
        timed("K7 generic combine", lambda: sgm_cuda._combine(partial, mask, 8, ALL_SWEEPS, order),
              **info)
        del vol, partial
        torch.cuda.empty_cache()
    h, w, D = chip_smoke.BENCH_SHAPE
    left, right = chip_smoke.stereo_pair(torch, h, w, seed=0)
    vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, "float32")
    py, px = p2_maps((h, w), 96.0, torch.float32, left.device, left, True, 24.0)
    timed("K10 sgm_aggregate_hwd",
          lambda: sgm_cuda.sgm_aggregate_hwd(vol, 8.0, 96.0, 8, left, True, 24.0), shape=[h, w, D])
    timed("K11 sweep_pair", lambda: sgm_cuda.sweep_pair(vol, py, 8.0, True), shape=[h, w, D])
    timed("K12 sgm_extract_fused",
          lambda: sgm_cuda.sgm_extract_fused(vol, py, px, 8.0, 8, True, 0.95, 1.5), shape=[h, w, D])
    del vol
    torch.cuda.empty_cache()


def e2e(torch, emit) -> None:
    """ms per frame (or frame-set) of the paths, at chip_smoke.py's
    configurations: two-view int8, int16 and float32 at 540x768x64, the flat
    two-view at 540x768x256 and its cascade, the array at CROSS, to_center,
    CROSS with ZNCC costs (float K7 in the wdh order) and its cascade."""
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.models import array_depth_pipeline, two_view_disparity

    h, w, D = chip_smoke.BENCH_SHAPE
    pair = chip_smoke.stereo_pair(torch, h, w, seed=0)
    sgm = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True)
    float_sgm = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True,
                                 uniqueness=0.95, lr_max_diff=1.5)
    tv_left, tv_right, _, _ = chip_smoke.two_view_cascade_scene(torch, pair[0].device)
    tv_cost, tv_sgm, _ = chip_smoke.two_view_cascade_config(config.CostConfig, config.SGMConfig)
    cams, images, _, casc_cfg = chip_smoke.array_cascade_scene(torch, pair[0].device)
    rows, cols, AH, AW, AD = chip_smoke.ARRAY_SHAPE
    array_cfg = config.EngineConfig().override(**{"camera.rows": rows, "camera.cols": cols,
                                                  "plane_sweep.num_planes": AD})
    runs = {"two_view_int8": (lambda: two_view_disparity(*pair, config.CostConfig(
                num_disparities=D, census_window=(7, 9), dtype="int8"), sgm), [h, w, D]),
            "two_view_int16": (lambda: two_view_disparity(*pair, config.CostConfig(
                num_disparities=D, census_window=(7, 9), dtype="int16"), sgm), [h, w, D]),
            "two_view_float32": (lambda: two_view_disparity(*pair, config.CostConfig(
                num_disparities=D, census_window=(7, 9), dtype="float32"), float_sgm),
                [h, w, D]),
            "two_view_flat_d256": (lambda: two_view_disparity(tv_left, tv_right, tv_cost, tv_sgm),
                                   list(chip_smoke.CASCADE_SHAPE)),
            "two_view_cascade": (lambda: chip_smoke.two_view_cascade_run(tv_left, tv_right),
                                 list(chip_smoke.CASCADE_SHAPE)),
            "array_cross": (lambda: array_depth_pipeline(images, cams, array_cfg.override(
                **{"plane_sweep.topology": "CROSS"})), list(chip_smoke.ARRAY_SHAPE)),
            "array_to_center": (lambda: array_depth_pipeline(images, cams, array_cfg),
                                list(chip_smoke.ARRAY_SHAPE)),
            "array_zncc": (lambda: array_depth_pipeline(images, cams, array_cfg.override(
                **{"plane_sweep.topology": "CROSS", "plane_sweep.cost": "zncc"})),
                list(chip_smoke.ARRAY_SHAPE)),
            "array_cascade": (lambda: array_depth_pipeline(images, cams, casc_cfg),
                              list(chip_smoke.ARRAY_SHAPE))}
    for name, (run, shape) in runs.items():
        frames = chip_smoke.ARRAY_FRAMES if name.startswith("array") else chip_smoke.TIMED_FRAMES
        line = {"e2e": name, "shape": shape, "frames": frames, "ms": cuda_ms(torch, run, frames)}
        if name.startswith("two_view"):  # the frame's device time, free of the host's pace
            line["device_ms"] = device_ms(torch, run, frames)
        emit(line)


if __name__ == "__main__":
    main()
