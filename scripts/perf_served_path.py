#!/usr/bin/env python3
"""The served capture path on an NVIDIA GPU: launches and host waits of its
new stages, and the serve loop against a serial loop.

    python3 scripts/perf_served_path.py [--repeats N]

For temporal_update (270x360), detect_face_ellipse, detect_face,
fit_landmarks and face_mask (a 270x360 head scene), fuse_depth_maps and one
array_depth_pipeline call (the 5x5 rig at 135x180, 96 planes, cameras on the
card, with and without use_roi), one JSON line each: the device events of
one warm call (torch.profiler), the synchronizing calls torch's sync debug
mode sees in it, and whether it returned while a ~0.5 s spin ran on the card
(a call that makes no host read still blocks once its launches fill the
device's launch queue). Then chip_smoke.py's phase 6e (serial, served at
depth 2 and chunked loops over 8 CROSS frame-sets from PNGs, in turns, and
the stages' times) `--repeats` times. Needs a CUDA device.
"""

import argparse
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from stereovisionarray_tpu_torch import _native  # noqa: E402
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array  # noqa: E402
from stereovisionarray_tpu_torch.models import (  # noqa: E402
    array_depth_pipeline,
    fuse_depth_maps,
    temporal_init,
    temporal_update,
)
from stereovisionarray_tpu_torch.roi import (  # noqa: E402
    detect_face,
    detect_face_ellipse,
    face_mask,
    fit_landmarks,
)


def device_events(fn) -> int:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def sync_calls(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def returns_behind_a_spin(fn) -> bool:
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)
    spinning = torch.cuda.Event()
    spinning.record()
    fn()
    returned_first = not spinning.query()
    torch.cuda.synchronize()
    return returned_first


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _native.timed_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = {"card": chip_smoke.device_line()}

    h, w = 270, 360
    rng = np.random.default_rng(11)
    d = torch.from_numpy(rng.uniform(1, 60, (h, w)).astype(np.float32)).cuda()
    v, c = d > 5.0, torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).cuda()
    head = torch.from_numpy(chip_smoke.render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h,
                                                   fw=0.25 * w, rng=rng)[0]).cuda()
    det = detect_face(head)
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(135, 180))
    images, depths = render_camera_array(cams, (135, 180))
    cams, images, depths = cams.to("cuda"), torch.from_numpy(images).cuda(), torch.from_numpy(
        depths).cuda()
    cfg = chip_smoke.fusion_config()
    stages = {
        "temporal_update": lambda: temporal_update(temporal_init((h, w), "cuda"), d, v, c),
        "detect_face_ellipse": lambda: detect_face_ellipse(head),
        "detect_face": lambda: detect_face(head),
        "fit_landmarks": lambda: fit_landmarks(head, det),
        "face_mask": lambda: face_mask(head),
        "fuse_depth_maps": lambda: fuse_depth_maps(cams, depths),
        "array_depth_pipeline": lambda: array_depth_pipeline(images, cams, cfg),
        "array_depth_pipeline_use_roi": lambda: array_depth_pipeline(images, cams, cfg,
                                                                     use_roi=True),
    }
    for name, fn in stages.items():
        fn()
        fn()
        print(json.dumps({"stage": name, "device_events": device_events(fn),
                          "synchronizing_calls": sync_calls(fn),
                          "returns_behind_a_spin": returns_behind_a_spin(fn), **tag}), flush=True)

    with tempfile.TemporaryDirectory(prefix="perf_served_") as tmp:
        scene = chip_smoke.served_scene(torch, tmp)
        for _ in range(args.repeats):
            chip_smoke.served_timing(torch, tag, *scene)


if __name__ == "__main__":
    main()
