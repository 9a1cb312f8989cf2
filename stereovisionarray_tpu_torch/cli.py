"""Command-line driver of the port (twin of ``stereovisionarray_tpu/cli.py``,
which replaced the original program's hard-coded ``main()``).

Subcommands::

    python -m stereovisionarray_tpu_torch render    --output data/      # synthetic dataset
    python -m stereovisionarray_tpu_torch depth     --input data/ --output out/
    python -m stereovisionarray_tpu_torch reconstruct --input data/ --output out/
    python -m stereovisionarray_tpu_torch two-view  --left L.png --right R.png
    python -m stereovisionarray_tpu_torch calibrate --input data/
    python -m stereovisionarray_tpu_torch serve     set_0/ set_1/ ... --output out/
    python -m stereovisionarray_tpu_torch evaluate  --result R.npz --ground-truth G.npz
    python -m stereovisionarray_tpu_torch inspect   out/depth.npz --at U V
    python -m stereovisionarray_tpu_torch config                        # dump defaults

Flags, defaults, artifact names and the keys of every printed JSON line are
the reference's, so scripts written against either CLI read the other's
output. Every subcommand accepts ``--config cfg.json`` (the same JSON in both
packages) and repeated ``--set dotted.key=value`` overrides. The reference's
``--platform`` becomes ``--device {cuda,cpu}`` (default ``cuda``) on the
subcommands that compute on tensors (depth, reconstruct, two-view,
calibrate, serve, evaluate): the pipelines run there, the kernels on the
card and their plain twins on the CPU. Without a card the default refuses to
run; nothing falls back to the CPU. ``config``, ``render`` and ``inspect``
compute in numpy and import no kernel wrapper. Each subcommand copies its
outputs to the host once, after all of its work has been enqueued.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from stereovisionarray_tpu_torch.config import EngineConfig


# --------------------------------------------------------------------- #
# plumbing
# --------------------------------------------------------------------- #
def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text  # bare string (e.g. topology names)


def load_config(args) -> EngineConfig:
    cfg = EngineConfig()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = EngineConfig.from_json(f.read())
    overrides = {}
    for item in getattr(args, "set", None) or []:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        k, v = item.split("=", 1)
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg


def _device(args):
    """The torch device of a computing subcommand; the card unless
    ``--device cpu``, and an error (not the CPU) where there is no card."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(args.device)


def _host(tensors: dict) -> dict:
    """Each tensor of `tensors` as a numpy array (None stays None): the one
    copy back from the card, made after the subcommand's work is enqueued."""
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in tensors.items()}


def _add_common(p: argparse.ArgumentParser, device: bool = True) -> None:
    p.add_argument("--config", help="EngineConfig JSON file")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="dotted config override, repeatable")
    if device:
        _add_device(p)
    p.add_argument("--output", default="out", help="artifact directory")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the pipeline runs: the card (kernels) or the CPU "
                        "(their plain twins)")


def _probe_report(maps: dict, probes) -> list:
    """Pixel probes on the pipeline's output maps (host arrays), the
    scriptable form of the original program's click-to-print callback: each
    (u, v) prints every map's value at that pixel."""
    out = []
    for (u, v) in probes or ():
        row = {"u": int(u), "v": int(v)}
        for name, arr in maps.items():
            a = np.asarray(arr)
            if not (0 <= int(v) < a.shape[0] and 0 <= int(u) < a.shape[1]):
                row[name] = None
            else:
                row[name] = a[int(v), int(u)].item()
        out.append(row)
    return out


def _add_probe(p: argparse.ArgumentParser) -> None:
    p.add_argument("--probe", type=int, nargs=2, action="append",
                   metavar=("U", "V"),
                   help="print live output values at pixel (u, v); repeatable")


def _rig_from_config(cfg: EngineConfig, resolution):
    """The config's rig, built from numpy on the host (it carries its host
    copy to the card, so host-side reads of it never wait for the stream)."""
    from stereovisionarray_tpu_torch.datasets import reference_rig

    cam = cfg.camera
    return reference_rig(
        rows=cam.rows, cols=cam.cols, spacing=cam.spacing, origin=cam.origin,
        z=cam.z, focal_length=cam.focal_length, sensor_width=cam.sensor_width,
        resolution=resolution,
    )


def _load_array_images(folder: str, half_res: bool):
    from stereovisionarray_tpu_torch.datasets import list_images_sorted, load_image_stack

    paths = list_images_sorted(folder)
    if not paths:
        raise SystemExit(f"no images found in {folder!r}")
    imgs = load_image_stack(paths, half_res=half_res)
    return imgs, paths


def _check_rig(n: int, cfg: EngineConfig) -> None:
    if n != cfg.camera.rows * cfg.camera.cols:
        raise SystemExit(
            f"{n} images but config rig is {cfg.camera.rows}x{cfg.camera.cols}; "
            f"fix with --set camera.rows=R --set camera.cols=C"
        )


def _center_index(cfg: EngineConfig) -> int:
    return (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2


# --------------------------------------------------------------------- #
# subcommands
# --------------------------------------------------------------------- #
def cmd_config(args) -> int:
    print(load_config(args).to_json())
    return 0


def cmd_render(args) -> int:
    """Synthesize the camera-array dataset and its exact ground-truth depth
    (numpy on the host)."""
    from stereovisionarray_tpu_torch.datasets import (
        SceneSpec, render_camera_array, save_array, save_png,
    )

    cfg = load_config(args)
    res = tuple(args.resolution)
    cams = _rig_from_config(cfg, res)
    scene = SceneSpec(texture_seed=cfg.seed)
    images, depths = render_camera_array(cams, res, scene)
    os.makedirs(args.output, exist_ok=True)
    for i, img in enumerate(images):
        save_png(os.path.join(args.output, f"view_{i:03d}.png"), img, vmin=0.0, vmax=255.0)
    save_array(os.path.join(args.output, "ground_truth.npz"),
               {"depths": depths},
               metadata={"config": cfg.to_dict(), "resolution": list(res)})
    print(json.dumps({"rendered": int(len(images)), "output": args.output,
                      "resolution": list(res)}))
    return 0


def cmd_depth(args) -> int:
    """The array pipeline: images -> ROI -> plane-sweep depth -> multi-view
    refinement -> artifacts (+ metrics against ground truth when found)."""
    device = _device(args)
    import torch

    from stereovisionarray_tpu_torch.datasets import load_array, save_array, save_png, save_ply
    from stereovisionarray_tpu_torch.evaluation import masked_mean_error
    from stereovisionarray_tpu_torch.geometry import depth_map_to_points, point_cloud_colors
    from stereovisionarray_tpu_torch.models import array_depth_pipeline
    from stereovisionarray_tpu_torch.parallel import to_device
    from stereovisionarray_tpu_torch.utils.obslog import MetricsLogger

    cfg = load_config(args)
    if getattr(args, "cascade", False):
        cfg = cfg.override(**{"plane_sweep.cascade": True})
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    _check_rig(n, cfg)
    cams = _rig_from_config(cfg, (h, w)).to(device)
    images = to_device(images, device)
    if args.undistort:
        from stereovisionarray_tpu_torch.geometry import Distortion, undistort_image

        # the whole stack in one pass, each view through its own camera
        images = undistort_image(images, cams, Distortion(*args.undistort))[0]
    out = array_depth_pipeline(images, cams, cfg, ref_index=args.ref_index, use_roi=args.roi)
    ref_index = _center_index(cfg) if args.ref_index is None else args.ref_index
    pts, pvalid = depth_map_to_points(cams[ref_index], out.refined_depth, mask=out.valid)
    col = point_cloud_colors(images[ref_index], pvalid)
    a = _host({"depth": out.refined_depth, "disparity": out.refined_disparity,
               "valid": out.valid, "confidence": out.sweep.confidence,
               "points": pts, "point_valid": pvalid, "colors": col})

    os.makedirs(args.output, exist_ok=True)
    log = MetricsLogger(os.path.join(args.output, "metrics.jsonl"))
    save_png(os.path.join(args.output, "depth.png"), a["depth"])
    save_png(os.path.join(args.output, "disparity.png"), a["disparity"])
    payload = {"depth": a["depth"], "disparity": a["disparity"], "valid": a["valid"]}
    if a["confidence"] is not None:
        payload["confidence"] = a["confidence"]
    save_array(os.path.join(args.output, "depth.npz"), payload,
               metadata={"config": cfg.to_dict()})
    n_pts = save_ply(os.path.join(args.output, "cloud.ply"), a["points"].reshape(-1, 3),
                     colors=a["colors"], valid=a["point_valid"].reshape(-1))

    result = {"valid_fraction": float(a["valid"].mean()),
              "points": int(n_pts), "output": args.output}
    if args.probe:
        result["probes"] = _probe_report(
            {"depth": a["depth"], "disparity": a["disparity"], "valid": a["valid"]}, args.probe)
    gt_path = args.ground_truth or os.path.join(args.input, "ground_truth.npz")
    if os.path.exists(gt_path):
        arrays, _meta = load_array(gt_path)
        gt = arrays["depths"][ref_index]
        err_mask = a["valid"] & (gt > 0)
        depth_np = a["depth"]
        result["mean_abs_err"] = float(masked_mean_error(
            torch.from_numpy(depth_np), torch.from_numpy(gt), torch.from_numpy(err_mask)))
        rel = np.abs(depth_np - gt)[err_mask] / gt[err_mask]
        result["median_rel_err"] = float(np.median(rel))
        # bad-τ on the GT-equivalent disparity scale
        result["bad_2pct_depth"] = float((rel > 0.02).mean())
        save_png(os.path.join(args.output, "error.png"), np.abs(depth_np - gt) * err_mask)
    log.log("depth", **result)
    print(json.dumps(result, sort_keys=True))
    return 0


def cmd_reconstruct(args) -> int:
    """Full-array reconstruction: every selected view gets its own depth
    map; geometric-consistency fusion merges them into one deduplicated
    point cloud (models/fusion.py)."""
    device = _device(args)
    import torch

    from stereovisionarray_tpu_torch.datasets import load_array, save_array, save_ply
    from stereovisionarray_tpu_torch.models.fusion import (
        FusionResult,
        depth_normals,
        fused_point_cloud,
        reconstruct_array,
    )
    from stereovisionarray_tpu_torch.parallel import to_device
    from stereovisionarray_tpu_torch.utils.obslog import MetricsLogger

    cfg = load_config(args)
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    _check_rig(n, cfg)
    cams = _rig_from_config(cfg, (h, w)).to(device)
    images = to_device(images, device)
    views = tuple(args.views) if args.views else tuple(range(n))
    result, _depths = reconstruct_array(
        images, cams, cfg, view_indices=views, use_roi=args.roi, rel_thresh=args.rel_thresh,
        min_support=args.min_support, min_confidence=args.min_confidence,
    )
    with_normals = args.voxel == 0.0 and not args.remove_outliers
    normals_dev = None
    if with_normals:
        # per-point world normals (depth_normals per view), compacted with
        # the cloud's mask; post-processing reorders / merges points, so
        # normals go out with the raw fused cloud only
        cams_sel = cams[list(views)]
        normals_dev = torch.stack([depth_normals(cams_sel[k], result.depth[k],
                                                 result.valid[k])[0]
                                   for k in range(len(views))])
    a = _host({**result._asdict(), "normals": normals_dev, "colors": images[list(views)]})
    # the cloud is compacted from the host copies; colors: each kept point
    # takes its source view's intensity
    pts, conf, col = fused_point_cloud(
        FusionResult(*(torch.from_numpy(a[k]) for k in FusionResult._fields)),
        torch.from_numpy(a["colors"]))
    os.makedirs(args.output, exist_ok=True)
    raw_points = int(pts.shape[0])
    if args.remove_outliers and pts.shape[0]:
        from stereovisionarray_tpu_torch.geometry import remove_outliers

        keep = remove_outliers(pts, voxel=args.outlier_voxel,
                               min_neighbors=args.outlier_min_neighbors)
        pts, conf = pts[keep], conf[keep]
        col = col[keep] if col is not None else None
    if args.voxel and pts.shape[0]:
        from stereovisionarray_tpu_torch.geometry import voxel_downsample

        pts, conf, col = voxel_downsample(pts, args.voxel, weights=conf, attributes=col)
    col3 = None
    if col is not None and col.size:
        c8 = np.clip(col, 0, 255).astype(np.uint8)
        col3 = np.stack([c8, c8, c8], axis=-1)
    normals = None
    if with_normals:
        normals = a["normals"].reshape(-1, 3)[a["valid"].reshape(-1)]
    n_pts = save_ply(os.path.join(args.output, "fused_cloud.ply"),
                     pts, colors=col3, normals=normals, quality=conf)
    save_array(os.path.join(args.output, "fused.npz"),
               {"depths": a["depth"], "valid": a["valid"], "support": a["support"],
                "confidence": a["confidence"], "views": np.asarray(views)},
               metadata={"config": cfg.to_dict()})
    out = {"points": int(n_pts), "raw_points": raw_points,
           "views": list(map(int, views)),
           "mean_support": float(a["support"][a["valid"]].mean()) if n_pts else 0.0,
           "output": args.output}
    gt_path = args.ground_truth or os.path.join(args.input, "ground_truth.npz")
    if os.path.exists(gt_path):
        arrays, _meta = load_array(gt_path)
        gt = np.stack([arrays["depths"][v] for v in views])
        kept = a["valid"] & (gt > 0)
        if kept.any():
            rel = np.abs(a["depth"] - gt)[kept] / gt[kept]
            out["median_rel_err"] = float(np.median(rel))
            out["bad_2pct_depth"] = float((rel > 0.02).mean())
    MetricsLogger(os.path.join(args.output, "metrics.jsonl")).log("reconstruct", **out)
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_two_view(args) -> int:
    """Rectified two-view SGM disparity (flat or coarse-to-fine)."""
    device = _device(args)
    from stereovisionarray_tpu_torch.datasets import load_image_gray, save_array, save_png
    from stereovisionarray_tpu_torch.models import two_view_disparity
    from stereovisionarray_tpu_torch.parallel import to_device

    cfg = load_config(args)
    left = to_device(load_image_gray(args.left, half_res=args.half_res), device)
    right = to_device(load_image_gray(args.right, half_res=args.half_res), device)
    kwargs = {}
    if args.baseline is not None and args.focal_px is not None:
        kwargs = {"baseline": args.baseline, "focal_px": args.focal_px}
    if getattr(args, "cascade", False):
        from stereovisionarray_tpu_torch.models import cascade_two_view_disparity

        out = cascade_two_view_disparity(
            left, right, cfg.cost, cfg.sgm, coarse_factor=args.coarse_factor,
            fine_disparities=args.fine_disparities, band_step=args.band_step,
            mode=getattr(args, "cascade_mode", "smooth"), **kwargs)
    else:
        out = two_view_disparity(left, right, cfg.cost, cfg.sgm, **kwargs)
    a = _host({"disparity": out.disparity, "valid": out.valid, "depth": out.depth,
               "confidence": out.confidence})
    os.makedirs(args.output, exist_ok=True)
    save_png(os.path.join(args.output, "disparity.png"), a["disparity"])
    payload = {"disparity": a["disparity"], "valid": a["valid"]}
    if a["depth"] is not None:
        payload["depth"] = a["depth"]
        save_png(os.path.join(args.output, "depth.png"), a["depth"])
    if a["confidence"] is not None:
        payload["confidence"] = a["confidence"]
        # absolute [0, 1] scale so confidence PNGs compare across runs
        save_png(os.path.join(args.output, "confidence.png"), a["confidence"],
                 vmin=0.0, vmax=1.0)
    save_array(os.path.join(args.output, "two_view.npz"), payload,
               metadata={"config": cfg.to_dict()})
    report = {"valid_fraction": float(a["valid"].mean()), "output": args.output}
    if a["confidence"] is not None:
        v = a["valid"]
        report["mean_confidence"] = float(a["confidence"][v].mean()) if v.any() else 0.0
    if args.probe:
        report["probes"] = _probe_report(payload, args.probe)
    print(json.dumps(report, sort_keys=True))
    return 0


def cmd_calibrate(args) -> int:
    """Feature-based array calibration and bundle adjustment from the
    array's own images."""
    device = _device(args)
    from stereovisionarray_tpu_torch.datasets import save_array
    from stereovisionarray_tpu_torch.models import calibrate_array
    from stereovisionarray_tpu_torch.parallel import to_device

    cfg = load_config(args)
    images, _paths = _load_array_images(args.input, args.half_res)
    n, h, w = images.shape
    cams = _rig_from_config(cfg, (h, w))
    ref_index = _center_index(cfg) if args.ref_index is None else args.ref_index
    result = calibrate_array(to_device(images, device), cams, ref_index, cfg.sfm,
                             estimate_distortion=args.estimate_distortion)
    k1, k2 = result.distortion if result.distortion is not None else (None, None)
    a = _host({"R": result.cameras.R, "t": result.cameras.t, "points": result.points,
               "point_valid": result.point_valid, "mean_reproj": result.mean_reproj,
               "inlier_reproj": result.inlier_reproj, "k1": k1, "k2": k2,
               "inlier_threshold_px": result.inlier_threshold_px,
               "outlier_fraction": result.outlier_fraction, "num_obs": result.num_obs})
    os.makedirs(args.output, exist_ok=True)
    save_array(os.path.join(args.output, "calibration.npz"),
               {"R": a["R"], "t": a["t"], "points": a["points"],
                "point_valid": a["point_valid"]},
               metadata={"config": cfg.to_dict()})
    print(json.dumps({
        "mean_reproj_px": float(a["mean_reproj"]),
        "inlier_reproj_px": float(a["inlier_reproj"]),
        **({"k1": float(a["k1"]), "k2": float(a["k2"])}
           if result.distortion is not None else {}),
        "inlier_threshold_px": float(a["inlier_threshold_px"]),
        "outlier_fraction": float(a["outlier_fraction"]),
        "num_obs": int(a["num_obs"]),
        "output": args.output,
    }, sort_keys=True))
    return 0


def cmd_serve(args) -> int:
    """Stream a sequence of array frame-set directories through the full
    pipeline, decoding and copying ahead of the card (models/serving.py)."""
    device = _device(args)
    import time

    from stereovisionarray_tpu_torch.datasets import save_array, save_png
    from stereovisionarray_tpu_torch.models import (
        frame_sets_from_dirs,
        stream_depth_maps_chunked,
    )
    from stereovisionarray_tpu_torch.utils.obslog import MetricsLogger

    cfg = load_config(args)
    dirs = sorted(args.inputs)
    os.makedirs(args.output, exist_ok=True)
    log = MetricsLogger(os.path.join(args.output, "metrics.jsonl"))

    first = _load_array_images(dirs[0], args.half_res)[0]
    n, h, w = first.shape
    if n != cfg.camera.rows * cfg.camera.cols:
        raise SystemExit(
            f"{n} images per frame set but rig is {cfg.camera.rows}x{cfg.camera.cols}"
        )
    # the rig's tensors go to the card once, before the stream starts
    cams = _rig_from_config(cfg, (h, w)).to(device)

    temporal = None
    if args.temporal:
        from stereovisionarray_tpu_torch.models import (
            TemporalParams,
            array_baselines,
            reference_and_sources,
        )

        ref_index, src = reference_and_sources(cfg, n, args.ref_index)
        _, b0 = array_baselines(cams, ref_index, src)
        f_px = float(np.broadcast_to(cams.host().fx, (n,))[ref_index])
        temporal = TemporalParams(baseline=b0, focal_px=f_px)
    stream = stream_depth_maps_chunked(
        frame_sets_from_dirs(dirs, half_res=args.half_res),
        cams, cfg, ref_index=args.ref_index, use_roi=args.roi,
        depth=args.prefetch, chunk=args.chunk, temporal=temporal, device=device,
    )

    t0 = time.perf_counter()
    count = 0
    for res in stream:
        if args.temporal:
            a = _host({"depth": res.depth, "valid": res.temporal.valid,
                       "stability": res.temporal.stability})
        else:
            a = _host({"depth": res.output.refined_depth, "valid": res.output.valid})
        save_png(os.path.join(args.output, f"depth_{res.index:04d}.png"), a["depth"])
        save_array(os.path.join(args.output, f"depth_{res.index:04d}.npz"), a)
        log.log("frame", index=res.index, decode_s=res.decode_s,
                valid_fraction=float(a["valid"].mean()))
        count += 1
    wall = time.perf_counter() - t0
    summary = {"frames": count, "wall_s": round(wall, 3),
               "frames_per_s": round(count / max(wall, 1e-9), 3),
               "output": args.output}
    log.log("serve_done", **summary)
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_evaluate(args) -> int:
    """Compare a result artifact against ground truth: masked mean (the
    original program's golden check), end-point error and bad-τ ratios."""
    device = _device(args)
    import torch

    from stereovisionarray_tpu_torch.datasets import load_array
    from stereovisionarray_tpu_torch.evaluation import (
        bad_pixel_ratio,
        end_point_error,
        masked_mean_error,
    )

    res, _ = load_array(args.result)
    gt_arrays, _ = load_array(args.ground_truth)

    if args.key not in res:
        raise SystemExit(f"{args.key!r} not in {args.result} (has {sorted(res)})")
    pred = torch.from_numpy(res[args.key]).to(device)
    gt_key = args.gt_key
    if gt_key is None:
        gt_key = args.key if args.key in gt_arrays else sorted(gt_arrays)[0]
    gt = gt_arrays[gt_key]
    if gt.ndim == pred.dim() + 1:  # per-view GT stack -> select one
        gt = gt[args.gt_index]
    gt = torch.from_numpy(np.ascontiguousarray(gt)).to(device)
    if gt.shape != pred.shape:
        raise SystemExit(f"shape mismatch: result {tuple(pred.shape)} vs gt {tuple(gt.shape)}")

    valid = (torch.from_numpy(res["valid"]).to(device) if "valid" in res
             else torch.ones(pred.shape, dtype=torch.bool, device=device))
    valid = valid & (gt > 0) if args.positive_gt_only else valid
    values = {"valid_fraction": valid.to(torch.float32).mean(),
              "masked_mean_err": masked_mean_error(pred, gt, mask=valid),
              "epe": end_point_error(pred, gt, mask=valid)}
    for tau in args.tau:
        values[f"bad_{tau}"] = bad_pixel_ratio(pred, gt, tau, mask=valid)
    report = {"key": args.key, "gt_key": gt_key,
              **{k: float(v) for k, v in _host(values).items()}}
    print(json.dumps(report, sort_keys=True))
    return 0


def cmd_inspect(args) -> int:
    """Pixel values and statistics of a saved artifact (the scriptable form
    of the original program's click-to-print callback)."""
    from stereovisionarray_tpu_torch.datasets import load_array

    path = args.artifact
    if path.endswith(".npz"):
        arrays, meta = load_array(path)
    else:
        from stereovisionarray_tpu_torch.datasets import load_image_gray

        arrays, meta = {"image": load_image_gray(path)}, {}
    report = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        entry = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if np.issubdtype(a.dtype, np.number):
            finite = a[np.isfinite(a.astype(np.float64))] if a.size else a
            entry.update(
                min=float(finite.min()) if finite.size else None,
                max=float(finite.max()) if finite.size else None,
                mean=float(finite.mean()) if finite.size else None,
                nonfinite=int((~np.isfinite(a.astype(np.float64))).sum()),
            )
        if args.at is not None and a.ndim >= 2:
            u, v = args.at
            if 0 <= v < a.shape[0] and 0 <= u < a.shape[1]:
                entry["at"] = {"u": u, "v": v, "value": a[v, u].tolist()}
            else:
                entry["at"] = {"u": u, "v": v, "value": None, "error": "out of bounds"}
        report[name] = entry
    if meta:
        report["__meta__"] = {"keys": sorted(meta.keys())}
    print(json.dumps(report, sort_keys=True))
    return 0


# --------------------------------------------------------------------- #
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="stereovisionarray_tpu_torch",
        description="Multi-view stereo / SfM engine on one NVIDIA GPU (PyTorch / CUDA)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("config", help="print the resolved config as JSON")
    p.add_argument("--config")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("render", help="render a synthetic camera-array dataset")
    _add_common(p, device=False)
    p.add_argument("--resolution", type=int, nargs=2, default=(270, 360),
                   metavar=("H", "W"))
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("depth", help="array images -> fused + refined depth")
    _add_common(p)
    p.add_argument("--input", required=True, help="folder of array images (sorted)")
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--roi", action="store_true", help="gate with detected face ROI")
    p.add_argument("--half-res", action="store_true",
                   help="0.5x ingest decimation (the original program's default)")
    p.add_argument("--undistort", type=float, nargs="*", default=None,
                   metavar="K", help="Brown-Conrady k1 k2 [p1 p2]: "
                   "undistort captures onto the ideal pinhole grid at ingest")
    p.add_argument("--ground-truth", help="npz with 'depths' (N,H,W)")
    p.add_argument("--cascade", action="store_true",
                   help="coarse-to-fine plane cascade (translation rigs; "
                        "equivalent to --set plane_sweep.cascade=true)")
    _add_probe(p)
    p.set_defaults(fn=cmd_depth)

    p = sub.add_parser("reconstruct",
                       help="array images -> per-view depths -> fused cloud")
    _add_common(p)
    p.add_argument("--input", required=True, help="folder of array images (sorted)")
    p.add_argument("--views", type=int, nargs="*", default=None,
                   help="view indices to reconstruct (default: all)")
    p.add_argument("--roi", action="store_true", help="gate with detected face ROI")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--rel-thresh", type=float, default=0.01,
                   help="relative depth-agreement tolerance")
    p.add_argument("--min-support", type=int, default=3,
                   help="min agreeing views (incl. self) to keep a point")
    p.add_argument("--min-confidence", type=float, default=0.0,
                   help="drop pixels below this PKRN matching confidence "
                        "before the consistency vote")
    p.add_argument("--voxel", type=float, default=0.0,
                   help="voxel-downsample the fused cloud (cell edge, "
                        "world units; confidence-weighted centroids)")
    p.add_argument("--remove-outliers", action="store_true",
                   help="grid-density outlier removal before export")
    p.add_argument("--outlier-voxel", type=float, default=0.005,
                   help="outlier-removal neighbourhood cell size")
    p.add_argument("--outlier-min-neighbors", type=int, default=3)
    p.add_argument("--ground-truth", help="npz with 'depths' (N,H,W)")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("two-view", help="rectified pair -> SGM disparity")
    _add_common(p)
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--baseline", type=float, help="metric baseline (for depth)")
    p.add_argument("--focal-px", type=float, help="focal length in pixels")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--cascade", action="store_true",
                   help="coarse-to-fine search (large disparity ranges)")
    p.add_argument("--cascade-mode", choices=("smooth", "band"),
                   default="smooth",
                   help="pre-warp: smooth field (default, seam-free) or "
                        "integer bands (fallback for scenes with strong "
                        "vertical disparity structure)")
    p.add_argument("--coarse-factor", type=int, default=4)
    p.add_argument("--fine-disparities", type=int, default=32)
    p.add_argument("--band-step", type=int, default=8)
    _add_probe(p)
    p.set_defaults(fn=cmd_two_view)

    p = sub.add_parser("calibrate", help="feature + BA array calibration")
    _add_common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--estimate-distortion", action="store_true",
                   help="solve Brown-Conrady (k1,k2) from vertical parallax "
                        "before BA (translation rigs)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("serve", help="stream frame-set dirs through the pipeline")
    _add_common(p)
    p.add_argument("inputs", nargs="+", help="directories, one frame set each")
    p.add_argument("--ref-index", type=int, default=None)
    p.add_argument("--roi", action="store_true")
    p.add_argument("--half-res", action="store_true")
    p.add_argument("--prefetch", type=int, default=2,
                   help="frame sets in flight ahead of the consumer")
    p.add_argument("--chunk", type=int, default=8,
                   help="frame sets per host-to-device copy (amortizes the "
                        "per-copy latency)")
    p.add_argument("--temporal", action="store_true",
                   help="recursive temporal filter across frame sets "
                        "(confidence-weighted; adds a stability map)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("evaluate", help="compare a result artifact vs ground truth")
    p.add_argument("--result", required=True, help="npz with the prediction")
    p.add_argument("--ground-truth", required=True, help="npz with GT arrays")
    p.add_argument("--key", default="depth", help="prediction array name")
    p.add_argument("--gt-key", default=None, help="GT array name (default: same)")
    p.add_argument("--gt-index", type=int, default=0,
                   help="view index when GT is a per-view stack")
    p.add_argument("--tau", type=float, nargs="*", default=(0.5, 1.0, 2.0),
                   help="bad-τ thresholds")
    p.add_argument("--positive-gt-only", action="store_true", default=True)
    _add_device(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("inspect", help="probe values/stats of a saved artifact")
    p.add_argument("artifact", help=".npz artifact or image file")
    p.add_argument("--at", type=int, nargs=2, metavar=("U", "V"),
                   help="print the value at pixel (u, v)")
    p.set_defaults(fn=cmd_inspect)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
