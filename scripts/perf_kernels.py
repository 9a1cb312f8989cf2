#!/usr/bin/env python3
"""Every kernel of the port timed on an NVIDIA GPU, at the shapes the paths
give it.

    python3 scripts/perf_kernels.py [--package-root DIR --tag NAME]

One JSON line a kernel and shape (the rows of PERF.md's kernel table): the
wrapper's ms (CUDA events around 20 calls), the device ms (the same calls
queued behind a GPU spin, :func:`device_ms`), the plain twin's ms, whether
kernel and twin agree bit for bit, the least time the shape allows (the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
``benchmark/rooflines.py`` where it has the kernel) and which of the two
bounds it, and, for K5 and K9, one PyTorch library call that computes the
same function. The shapes and scenes are ``tests/torch_records.py``'s: the
two-view bench shape (540x768x64; int8, float32 for K6-K12), every K1 and
K4 shape a path gives (K4 at KITTI's 375x1242x256 too, the kitti2015_sgm
cells' shape), the array cells' K8 and refinement passes
(270x360x128, CROSS and to_center), K2/K3 and K4 on the CROSS plane volume,
K7 at the array's ZNCC shape, K9 at the cascades' shapes.

``--package-root DIR`` times the package of another checkout (an unpacked
older commit), so that two versions compare within one call. Every line is
also written to ``chiprun_out/perf_kernels[_TAG].json``. Needs a CUDA
device. :func:`device_line`, :func:`cuda_ms` and :func:`device_ms` are the
timing helpers the other ``perf_*`` scripts share.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"
TIMED_FRAMES = 20
PLAIN_FRAMES = 3  # the plain twins run thousands of small launches a call


def device_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise SystemExit("nvidia-smi printed nothing")
    return out


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
    """Wall ms of one fn() between CUDA events around `iters` calls."""
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


def _equal(torch, got, want) -> bool:
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return all((a is None and b is None) or torch.equal(a, b) for a, b in pairs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=REPO,
                    help="checkout whose stereovisionarray_tpu_torch to time")
    ap.add_argument("--tag", default="", help="suffix of the output file and label of each line")
    args = ap.parse_args()
    root = args.package_root.resolve()
    sys.path[:0] = [str(root), str(REPO), str(REPO / "tests")]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_kernels: needs a CUDA device")
    import torch_records as rec
    from benchmark import rooflines
    from stereovisionarray_tpu_torch import config
    from stereovisionarray_tpu_torch.models import (
        array_baselines,
        array_depth_pipeline,
        reference_and_sources,
    )
    from stereovisionarray_tpu_torch.models.array_pipeline import _shift_warp_pad
    from stereovisionarray_tpu_torch.models.cascade import SMOOTH_R
    from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
    from stereovisionarray_tpu_torch.models.two_view import scaled_penalties
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.extract_cuda import (
        extract_disparity_maps,
        extract_maps,
        lr_gather,
    )
    from stereovisionarray_tpu_torch.ops.hatsample import hat_sample, hat_sample_2d
    from stereovisionarray_tpu_torch.ops.refine import multiview_refine
    from stereovisionarray_tpu_torch.ops.sgm import p2_maps, sum_dtype
    from stereovisionarray_tpu_torch.ops.sgm_cuda import (
        sgm_aggregate_float,
        sgm_aggregate_hwd,
        sgm_aggregate_paths,
        sgm_extract_fused,
        sweep_pair,
    )
    from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census

    torch.backends.cuda.matmul.allow_tf32 = False
    card = device_line()
    print(card, flush=True)
    suffix = f"_{args.tag}" if args.tag else ""
    lines = []

    def emit(kernel, shape, call, bound, **extra):
        """Time call("cuda") and call("torch"); print and keep the line."""
        got, want = call("cuda"), call("torch")
        line = {"kernel": kernel, "shape": shape, **extra,
                "ms": cuda_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
                "device_ms": device_ms(torch, lambda: call("cuda"), TIMED_FRAMES),
                "plain_ms": cuda_ms(torch, lambda: call("torch"), PLAIN_FRAMES, warmup=1),
                "bit_exact": _equal(torch, got, want)}
        del got, want
        if bound is not None:
            line["bound_ms"], line["bound_by"] = rooflines.bound_ms(*bound)
        line.update(tag=args.tag, card=card)
        lines.append(line)
        print(json.dumps(line), flush=True)
        return line

    # ---- the two-view kernels at the bench shape (int8 costs, 8 paths) ----
    h, w, D = rec.BENCH_SHAPE
    hw, hwd = h * w, h * w * D
    sgm_cfg = config.SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True, uniqueness=0.95,
                               lr_max_diff=1.5)
    cc = config.CostConfig(num_disparities=D, census_window=(7, 9), dtype="int8")
    pen = scaled_penalties(cc, sgm_cfg, "int8")
    left, right = rec.stereo_pair(torch, h, w, 1, integer=True)
    p2_y, p2_x = p2_maps((h, w), pen.p2, sum_dtype(pen.dtype), left.device, left, True, pen.p2_min)
    vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, pen.dtype)
    total = sgm_aggregate_paths(vol, p2_y, p2_x, pen.p1, 8)
    maps = extract_maps(total, True, 0.95)
    emit("K1 cost_volume", [h, w, D],
         lambda b: fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, pen.dtype, b),
         rooflines.cost_volume(h, w, D, (7, 9), 1), dtype="int8")
    emit("K2/K3 sgm_paths", [h, w, D],
         lambda b: sgm_aggregate_paths(vol, p2_y, p2_x, pen.p1, 8, b),
         rooflines.sgm_paths(h, w, D, 1), dtype="int8")
    # K4 with the right map: four maps and the right disparity written
    emit("K4 extract_maps", [h, w, D], lambda b: extract_maps(total, True, 0.95, b),
         (hwd * 2 + hw * 17, hwd * 6), dtype="int16")
    emit("K5 lr_gather", [h, w], lambda b: lr_gather(maps.disparity, maps.disparity_right, D, b),
         (hw * 12, hw * 4))
    emit("K5 lr_check fused", [h, w, D],
         lambda b: extract_maps(total, True, 0.95, b, lr_max_diff=1.5, right=False),
         rooflines.extract_maps(h, w, D, True), dtype="int16")
    del vol, total

    # K1 and K4 at every other shape a path gives them
    for row, (ch, cw, cd), window, vtype in rec.K1_ROWS:
        if row in ("two_view_bench_int8", "generic_d47") or row.startswith(("parity", "golden")):
            continue
        lo, ro = rec.stereo_pair(torch, ch, cw, seed=ch + cd, integer=vtype == "int8")
        emit("K1 cost_volume", [ch, cw, cd],
             lambda b: fused_cost_volume_cuda(lo, ro, cd, window, 0.25, 32.0, vtype, b),
             rooflines.cost_volume(ch, cw, cd, window, rec.ELEMENT_BYTES[vtype]), row=row,
             window=list(window), dtype=vtype)
    for row, kernel, (eh, ew, ed), vtype, lr in rec.EXTRACT_ROWS:
        if row not in ("two_view_flat_d256", "two_view_kitti", "array_sgm"):
            continue
        volume = rec.extraction_volume(torch, eh, ew, ed, vtype)
        emit("K4 extract_maps", [eh, ew, ed],
             rec.extraction_call(extract_maps, extract_disparity_maps, kernel, volume, lr),
             rooflines.extract_maps(eh, ew, ed, lr), row=row, dtype=vtype, lr=lr)
        del volume

    # ---- the array: K8 at both cells, K2/K3 and K4 on the CROSS plane volume, R ----
    rows, cols, AH, AW, AD = rec.ARRAY_SHAPE
    cams = reference_rig(rows=rows, cols=cols, spacing=0.05, resolution=(AH, AW))
    images = torch.from_numpy(render_camera_array(cams, (AH, AW))[0]).cuda()
    for cell, topology in (("array_cross", "CROSS"), ("array_tocenter", "to_center")):
        cfg = config.EngineConfig().override(**{
            "camera.rows": rows, "camera.cols": cols, "plane_sweep.num_planes": AD,
            "plane_sweep.topology": topology})
        ps = cfg.plane_sweep
        ref, src = reference_and_sources(cfg, rows * cols)
        shifts = torch.from_numpy(np.ascontiguousarray(translation_shifts(
            cams, ref, src, inverse_depth_samples(ps.z_near, ps.z_far, AD)).swapaxes(0, 1))).cuda()
        topk = ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None
        sweep_in = (images[ref].contiguous(), images[list(src)].contiguous(), shifts)
        emit("K8 plane_sweep", [AH, AW, AD],
             lambda b: plane_sweep_census(*sweep_in, ps.patch, ps.fusion == "mean", topk, b),
             rooflines.plane_sweep(AH, AW, AD, len(src)), run=cell, sources=len(src), topk=topk)
        if topology == "CROSS":  # quantized as the array path's _volume_to_maps does
            q = torch.round(plane_sweep_census(*sweep_in, ps.patch, False, topk)[0] * 4).to(
                torch.int8)
            sgm = cfg.sgm
            qy, qx = p2_maps((AH, AW), round(sgm.p2 * 4), torch.int16, q.device, sweep_in[0],
                             sgm.adaptive_p2, round(sgm.p2_min * 4))
            qtotal = sgm_aggregate_paths(q, qy, qx, round(sgm.p1 * 4), sgm.num_paths)
            emit("K2/K3 sgm_paths", [AH, AW, AD],
                 lambda b: sgm_aggregate_paths(q, qy, qx, round(sgm.p1 * 4), sgm.num_paths, b),
                 rooflines.sgm_paths(AH, AW, AD, 1), run=cell, dtype="int8")
            emit("K4 extract_maps", [AH, AW, AD],
                 lambda b: extract_maps(qtotal, True, 0.0, b, right=False),
                 rooflines.extract_maps(AH, AW, AD, False), run=cell, dtype="int16")
        # R at the pipeline's own pass; reference, disparity, mask and the V
        # views read, four outputs written; ~30 operations a view term of 11
        # offsets
        out = array_depth_pipeline(images, cams, cfg)
        bl, _ = array_baselines(cams, ref, src)
        rc = cfg.refine
        ceiling = float(out.disparity.max()) + 2 * abs(rc.radius * rc.step)
        aux = images[list(src)].contiguous()
        views = len(src)
        emit("R refine", [AH, AW],
             lambda b: multiview_refine(images[ref], aux, bl, out.disparity,
                                        mask=out.mask & out.valid, radius=rc.radius, step=rc.step,
                                        window=rc.window, subpixel=rc.subpixel,
                                        max_disparity=ceiling, backend=b),
             (AH * AW * (4 * views + 22), 11 * views * AH * AW * 30), run=cell, views=views)

    # ---- K9 at the cascades' shapes, its 2-D form at the array pre-warp ----
    CH, CW, _ = rec.CASCADE_SHAPE
    casc = config.EngineConfig().override(**{
        "camera.rows": rows, "camera.cols": cols, "plane_sweep.num_planes": AD,
        **rec.ARRAY_CASCADE})
    c_ref, c_src = reference_and_sources(casc, rows * cols)
    pre_r = _shift_warp_pad(cams, c_ref, c_src, casc) + 1  # the pre-warp's half-range
    rng = np.random.default_rng(0)

    def cuda_uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).cuda()

    for case, shape, k0, k1, aux_table, axis in (
            ("two_view_warp", (CH, CW), -SMOOTH_R, SMOOTH_R, True, -1),
            ("two_view_decode", (CH, CW), 0, 23, False, -1),
            ("array_prewarp_rows", (len(c_src), AH, AW), -pre_r, pre_r, False, -2),
            ("array_prewarp_cols", (len(c_src), AH, AW), -pre_r, pre_r, False, -1)):
        values, t = cuda_uniform(0.0, 255.0, shape), cuda_uniform(k0 - 1.5, k1 + 1.5, shape)
        a = cuda_uniform(0.0, 200.0, shape[-1]) if aux_table else None
        n = int(np.prod(shape))
        emit("K9 hat_sample", list(shape),
             lambda b: hat_sample(values, t, k0, k1, aux=a, axis=axis, backend=b),
             (n * (16 if aux_table else 12) + (shape[-1] * 4 if aux_table else 0), n * 12),
             case=case, taps=[k0, k1])
    shape = (len(c_src), AH, AW)
    values, t_rows, t_cols = (cuda_uniform(lo, hi, shape) for lo, hi in (
        (0.0, 255.0), (-pre_r - 1.5, pre_r + 1.5), (-pre_r - 1.5, pre_r + 1.5)))

    def two_passes():
        return hat_sample(hat_sample(values, t_rows, -pre_r, pre_r, axis=-2), t_cols, -pre_r,
                          pre_r)

    n = int(np.prod(shape))
    emit("K9 hat_sample_2d", list(shape),
         lambda b: hat_sample_2d(values, t_rows, t_cols, -pre_r, pre_r, b), (n * 16, n * 24),
         case="array_prewarp_2d", taps=[-pre_r, pre_r],
         two_k9_launches_device_ms=device_ms(torch, two_passes, TIMED_FRAMES))

    # ---- the float kernels at the bench shape, K7 at the array's ZNCC shape ----
    fl, fr = rec.stereo_pair(torch, h, w, 0)
    fvol = fused_cost_volume_cuda(fl, fr, D, (7, 9), 0.25, 32.0, "float32")
    fy, fx = p2_maps((h, w), 96.0, torch.float32, fl.device, fl, True, 24.0)
    ftotal = sgm_aggregate_float(fvol, fy, fx, 8.0)
    emit("K6 extract_volume", [h, w, D],
         lambda b: extract_disparity_maps(ftotal, True, 0.95, 1.5, b),
         (hwd * 4 + hw * 13, hwd * 6 + hw * 4), dtype="float32")
    emit("K6 extract_volume", [h, w, D],
         lambda b: extract_disparity_maps(ftotal, True, 0.0, 0.0, b), None, dtype="float32",
         variant="no_lr")
    emit("K7 strips", [h, w, D], lambda b: sgm_aggregate_float(fvol, fy, fx, 8.0, 8, backend=b),
         (hwd * 8 + 2 * hw * 4, 8 * hwd * 8 + 7 * hwd), order="k7")
    emit("K7 generic", [h, w, D],  # a sweep subset: 7 paths, 6 adds
         lambda b: sgm_aggregate_float(fvol, fy, fx, 8.0, 8, ("down", "up", "lr"), backend=b),
         (hwd * 8 + 2 * hw * 4, 7 * hwd * 8 + 6 * hwd), sweeps=["down", "up", "lr"])
    emit("K10 sgm_aggregate_hwd", [h, w, D],
         lambda b: sgm_aggregate_hwd(fvol, 8.0, 96.0, 8, fl, True, 24.0, b),
         (hwd * 8 + hw * 4, 8 * hwd * 8 + 7 * hwd))
    emit("K11 sweep_pair", [h, w, D], lambda b: sweep_pair(fvol, fy, 8.0, True, b),
         (hwd * 12 + hw * 4, 6 * hwd * 8 + 4 * hwd))
    emit("K12 sgm_extract_fused", [h, w, D],
         lambda b: sgm_extract_fused(fvol, fy, fx, 8.0, 8, True, 0.95, 1.5, b),
         (hwd * 4 + 2 * hw * 4 + hw * 13, 8 * hwd * 8 + 13 * hwd))
    del fvol, ftotal
    al, ar = rec.stereo_pair(torch, AH, AW, 3)
    avol = fused_cost_volume_cuda(al, ar, AD, (7, 9), 0.25, 32.0, "float32")
    ay, ax = p2_maps((AH, AW), 96.0, torch.float32, al.device, al, True, 24.0)
    ahwd = AH * AW * AD
    emit("K7 strips", [AH, AW, AD],
         lambda b: sgm_aggregate_float(avol, ay, ax, 8.0, 8, order="wdh", backend=b),
         (ahwd * 8 + 2 * AH * AW * 4, 8 * ahwd * 8 + 7 * ahwd), order="wdh", run="array_zncc")
    del avol

    # ---- one PyTorch library call computing the same function ----
    disp_r = torch.from_numpy(rng.uniform(0, D - 1, (h, w)).astype(np.float32)).cuda()
    src_col = torch.from_numpy(rng.integers(0, w, (h, w))).cuda()
    values = torch.from_numpy(rng.uniform(0, 255, (1, 1, CH, CW)).astype(np.float32)).cuda()
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, CH, CW, 2)).astype(np.float32)).cuda()
    # (grid_sample, one channel on a random grid, computes no aux output: the
    # timed two_view_warp case does)
    for kernel, name, fn in (
            ("K5 lr_gather", "torch.gather", lambda: torch.gather(disp_r, 1, src_col)),
            ("K9 hat_sample", "torch.nn.functional.grid_sample",
             lambda: torch.nn.functional.grid_sample(values, grid, "bilinear", "border",
                                                     align_corners=True))):
        line = {"library_call": name, "for": kernel, "ms": cuda_ms(torch, fn, TIMED_FRAMES),
                "device_ms": device_ms(torch, fn, TIMED_FRAMES), "tag": args.tag, "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)

    OUT.mkdir(exist_ok=True)
    (OUT / f"perf_kernels{suffix}.json").write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
