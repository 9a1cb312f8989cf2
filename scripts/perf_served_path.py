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
device's launch queue). Then :func:`served_timing` (serial, served at
depth 2 and chunked loops over 8 CROSS frame-sets from PNGs, in turns, and
the stages' times) `--repeats` times. Needs a CUDA device.
"""

import argparse
import json
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]
import torch_records as rec  # noqa: E402
from perf_kernels import cuda_ms, device_line, device_ms  # noqa: E402
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

ARRAY_FRAMES = 10
TIMED_FRAMES = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def served_timing(tag, cams, cfg, dirs, params) -> None:
    """The served loop against a serial loop, the chunked loop, and the
    served stages' times, with CUDA events or a host clock that ends in a
    synchronize: one JSON line each."""
    from stereovisionarray_tpu_torch.datasets import load_image_stack, native_available
    from stereovisionarray_tpu_torch.datasets.io import list_images_sorted
    from stereovisionarray_tpu_torch.models import (
        reconstruct_array,
        serving,
        stream_depth_maps,
        stream_depth_maps_chunked,
    )
    from stereovisionarray_tpu_torch.parallel import to_device

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

    rows, cols, h, w, _ = rec.ARRAY_SHAPE
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
    head = torch.from_numpy(rec.render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h, fw=0.25 * w,
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
             lambda: reconstruct_array(fimages, fcams, rec.fusion_config()), 1)):
        ms = cuda_ms(torch, fn, iters, warmup=1)
        # one call queued behind a spin: more would fill the device's launch
        # queue and block the host (fusion's ~2,000 launches a call do alone)
        dev = device_ms(torch, fn, 1) if name in ("temporal_update", "face_mask") else None
        emit({"phase": "timing", "metric": f"{name}_ms", "shape": shape, "iters": iters,
              "ms": ms, "device_ms": dev, **tag})



def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _native.timed_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = {"card": device_line()}

    h, w = 270, 360
    rng = np.random.default_rng(11)
    d = torch.from_numpy(rng.uniform(1, 60, (h, w)).astype(np.float32)).cuda()
    v, c = d > 5.0, torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).cuda()
    head = torch.from_numpy(rec.render_head(h=h, w=w, cu=0.55 * w, cv=0.45 * h, fw=0.25 * w,
                                            rng=rng)[0]).cuda()
    det = detect_face(head)
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(135, 180))
    images, depths = render_camera_array(cams, (135, 180))
    cams, images, depths = cams.to("cuda"), torch.from_numpy(images).cuda(), torch.from_numpy(
        depths).cuda()
    cfg = rec.fusion_config()
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
        scene = rec.served_scene(torch, tmp)
        for _ in range(args.repeats):
            served_timing(tag, *scene)


if __name__ == "__main__":
    main()
