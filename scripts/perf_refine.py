#!/usr/bin/env python3
"""The refinement's static-stack pass on an NVIDIA GPU: the fused kernels
(csrc/refine.cu) against the plain PyTorch route, on the same inputs.

    python3 scripts/perf_refine.py [--iters N]

For the array cell's pass (270x360, CROSS, radius 5, window 21), a
to_center pass (24 views, the hat blend) and a KITTI-width CROSS pass
(375x1242), one JSON line each with, per route: ms a pass through the
wrapper (host clock, the calls back to back, then a synchronize), device ms
a pass (the sum of its kernels' durations in a torch.profiler trace), device
ms by kernel, launches a pass and whether the outputs agree bit for bit;
beside them the pass's least time on the card (bytes over 3.35 TB/s or
operations over 67 TFLOP/s, the larger). The first line names the card and
its power limit; everything is also written to chiprun_out/perf_refine.json.
Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from stereovisionarray_tpu_torch.ops import refine  # noqa: E402

CROSS = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
_OFF = np.array([(c - 2, r - 2) for r in range(5) for c in range(5) if (r, c) != (2, 2)],
                np.float64)
TO_CENTER = -_OFF / np.linalg.norm(_OFF, axis=1).mean()
CASES = [("array_cross", CROSS, 270, 360), ("to_center", TO_CENTER, 270, 360),
         ("kitti_width_cross", CROSS, 375, 1242)]
RADIUS, WINDOW, CEILING = 5, 21, 51.0
FLOPS_PER_VIEW_TERM = 30  # in-view test, two stack samples, blend, difference, sum


def inputs(bl, h, w, seed=0):
    rng = np.random.default_rng(seed)
    cuda = lambda a, t=torch.float32: torch.from_numpy(a).to(t).cuda()  # noqa: E731
    ref = np.round(rng.uniform(0, 255, (h, w)))
    aux = np.round(rng.uniform(0, 255, (len(bl), h, w)))
    disp = 20.0 + rng.normal(0, 1.0, (h, w))
    return cuda(ref), cuda(aux), cuda(disp), cuda(rng.uniform(size=(h, w)) > 0.1, torch.bool)


def bound_ms(views, h, w):
    """The pass's least time: reference, disparity, mask and the views read
    once, the four outputs written once; the data term's operations."""
    n = h * w
    bytes_ = n * (4 * (2 + views) + 1) + n * (3 * 4 + 1)
    ops = (2 * RADIUS + 1) * views * n * FLOPS_PER_VIEW_TERM
    by_bytes, by_ops = bytes_ / 3.35e12, ops / 67e12
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def device_ms(fn, iters):
    """Sum of the kernels' device durations a call, by kernel name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name, launches = defaultdict(float), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Memcpy"):
            by_name[e.name[:60]] += e.device_time_total / 1e3 / iters
            launches += 1
    return sum(by_name.values()), dict(by_name), launches / iters


def wall_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("perf_refine.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    for name, bl, h, w in CASES:
        ref, aux, disp, mask = inputs(bl, h, w)
        row = {"case": name, "shape": [len(bl), h, w], "radius": RADIUS, "window": WINDOW}
        outs = {}
        for route, backend in (("fused", "cuda"), ("plain", "torch")):
            call = lambda: refine.multiview_refine(ref, aux, bl, disp, mask=mask,  # noqa: E731
                                                   radius=RADIUS, window=WINDOW,
                                                   max_disparity=CEILING, backend=backend)
            iters = args.iters if route == "fused" else max(2, args.iters // 10)
            outs[route] = call()
            dev, by_name, launches = device_ms(call, iters)
            row[route] = {"ms": wall_ms(call, iters), "device_ms": dev,
                          "launches": launches, "kernels": by_name}
        row["bit_exact"] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                               for a, b in zip(outs["fused"], outs["plain"]))
        row["bound_ms"], row["bound_by"] = bound_ms(len(bl), h, w)
        lines.append(row)
        print(json.dumps(row), flush=True)
    out = REPO / "chiprun_out" / "perf_refine.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
