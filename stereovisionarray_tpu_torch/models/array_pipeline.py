"""End-to-end camera-array depth pipeline (twin of
``stereovisionarray_tpu/models/array_pipeline.py``): plane sweep over the
array (K8 + SGM K2/K3 + extraction K4 on a CUDA tensor; with
``plane_sweep.cascade`` the coarse-to-fine sweep of ``models/cascade_sweep.py``,
which adds the hat-sampling pre-warp K9), disparity in the reference-baseline
scale, multi-view photoconsistency refinement.

Host code selects the reference and source views and derives the static
shift bound and the baselines from the rig; every numeric stage runs on the
images' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.topology import PairTopology, camera_pairs
from stereovisionarray_tpu_torch.models.cascade_sweep import (
    cascade_plane_sweep_depth,
    cascade_static_params,
)
from stereovisionarray_tpu_torch.models.plane_sweep import PlaneSweepOutput, plane_sweep_depth
from stereovisionarray_tpu_torch.models.two_view import depth_to_disparity, disparity_to_depth
from stereovisionarray_tpu_torch.ops.refine import multiview_refine

__all__ = ["ArrayPipelineOutput", "array_baselines", "array_depth_pipeline",
           "reference_and_sources"]


def _host_centers(cameras: CameraArray) -> np.ndarray:
    """(N, 3) camera centres as host numpy, C = -R^T t."""
    host = cameras.host()
    return -np.einsum("nji,nj->ni", host.R, host.t)


def _shift_warp_pad(cameras: CameraArray, ref_index: int, src_indices, cfg: EngineConfig) -> int:
    """Static bound on the translation warp's shift, or 0 when the rig is not
    translation-only (general homographies needed)."""
    host = cameras.host()
    n = len(cameras)
    eye = np.broadcast_to(np.eye(3, dtype=host.R.dtype), host.R.shape)
    if not np.allclose(host.R, eye, atol=1e-6):
        return 0
    centers = _host_centers(cameras)
    idx = [ref_index, *src_indices]
    if not np.allclose(centers[idx, 2], centers[ref_index, 2], atol=1e-9):
        return 0  # differing z: the homography has a scale term
    fx = np.broadcast_to(host.fx, (n,))
    fy = np.broadcast_to(host.fy, (n,))
    if not (np.allclose(fx[idx], fx[ref_index]) and np.allclose(fy[idx], fy[ref_index])):
        return 0
    rel = centers[list(src_indices), :2] - centers[ref_index, :2]
    max_base = float(np.abs(rel).max())
    f_max = float(max(fx[ref_index], fy[ref_index]))
    cx = np.broadcast_to(host.cx, (n,))
    cy = np.broadcast_to(host.cy, (n,))
    # differing principal points add a constant shift on top of the baseline term
    dpp = float(max(np.abs(cx[idx] - cx[ref_index]).max(), np.abs(cy[idx] - cy[ref_index]).max()))
    return int(np.ceil(f_max * max_base / cfg.plane_sweep.z_near + dpp)) + 2


class ArrayPipelineOutput(NamedTuple):
    depth: torch.Tensor  # (H, W) fused depth before refinement
    refined_depth: torch.Tensor  # (H, W) after multi-view refinement
    disparity: torch.Tensor  # (H, W) normalized disparity (reference-baseline units)
    refined_disparity: torch.Tensor
    valid: torch.Tensor  # (H, W)
    mask: torch.Tensor  # (H, W) ROI gate actually applied
    sweep: PlaneSweepOutput  # full plane-sweep diagnostics


def array_baselines(cameras: CameraArray, ref_index: int,
                    src_indices: Tuple[int, ...]) -> Tuple[np.ndarray, float]:
    """Per-view pixel-space epipolar directions, scaled to one disparity
    scale (the mean baseline B0): (baselines_uv (V, 2) float32, B0)."""
    centers = _host_centers(cameras)
    rel = centers[ref_index][None, :2] - centers[list(src_indices), :2]
    b_len = np.linalg.norm(rel, axis=-1)
    b0 = float(b_len.mean())
    unit = rel / np.maximum(b_len[:, None], 1e-12)
    return (unit * (b_len / max(b0, 1e-12))[:, None]).astype(np.float32), b0


def reference_and_sources(cfg: EngineConfig, n: int,
                          ref_index: Optional[int] = None) -> Tuple[int, Tuple[int, ...]]:
    """The reference view (grid centre by default) and its source views under
    cfg.plane_sweep.topology."""
    if ref_index is None:
        ref_index = (cfg.camera.rows // 2) * cfg.camera.cols + cfg.camera.cols // 2
        if ref_index >= n:
            ref_index = n // 2
    pairs = camera_pairs(PairTopology(cfg.plane_sweep.topology), rows=cfg.camera.rows,
                         cols=cfg.camera.cols, center=ref_index)
    src = tuple(int(b) for a, b in pairs if a == ref_index) or tuple(int(b) for _, b in pairs)
    return int(ref_index), src


def array_depth_pipeline(
    images: torch.Tensor,
    cameras: CameraArray,
    cfg: EngineConfig = EngineConfig(),
    ref_index: Optional[int] = None,
    use_roi: bool = False,
    mask: Optional[torch.Tensor] = None,
    roi_mode: str = "face",
    backend: str = "auto",
) -> ArrayPipelineOutput:
    """Depth of the reference view from (N, H, W) grayscale array images.

    cameras: the matching CameraArray. cfg: engine config (plane_sweep, sgm
    and refine sections). ref_index: default the grid centre. mask: explicit
    (H, W) ROI. use_roi / roi_mode: the face-ROI detector, not ported yet.
    backend: "auto" (kernels for CUDA tensors, plain PyTorch for CPU
    tensors), "cuda" (kernels, CUDA tensors only) or "torch" (plain PyTorch
    on any device)."""
    resolve_backend(images, backend)  # "cuda" refuses a CPU tensor here, before any work
    images = images.to(torch.float32)
    n, h, w = images.shape
    ref_index, src_indices = reference_and_sources(cfg, n, ref_index)
    if mask is None:
        if use_roi:
            raise NotImplementedError(
                f"use_roi (roi_mode={roi_mode!r}) needs the face-ROI detector of roi/, "
                "not ported yet (ROADMAP.md queue 1 item 6); pass an explicit mask")
        mask = torch.ones((h, w), dtype=torch.bool, device=images.device)

    shift_pad = _shift_warp_pad(cameras, ref_index, src_indices, cfg)
    ps = cfg.plane_sweep
    if ps.cascade and ps.num_planes <= ps.cascade_fine_planes:
        # the whole range fits one fine window: the cascade would run the same sweep
        cfg = cfg.override(**{"plane_sweep.cascade": False})
    if cfg.plane_sweep.cascade:
        if shift_pad <= 0:
            raise ValueError("plane_sweep.cascade requires a translation-only rig "
                             "(general rigs have non-linear per-plane warps)")
        ps = cfg.plane_sweep
        band_offsets, _ = cascade_static_params(cameras, ref_index, src_indices, ps,
                                                ps.cascade_fine_planes)
        # the full-range shift bound serves the fine pass too, as in the reference
        sweep = cascade_plane_sweep_depth(
            images, cameras, ref_index, src_indices, ps, cfg.sgm, mask=mask, backend=backend,
            shift_pad=shift_pad, coarse_factor=ps.cascade_coarse_factor,
            fine_planes=ps.cascade_fine_planes, band_step=ps.cascade_band_step,
            band_offsets=band_offsets, mode=ps.cascade_mode)
    else:
        sweep = plane_sweep_depth(images, cameras, ref_index, src_indices, cfg.plane_sweep,
                                  cfg.sgm, mask=mask, backend=backend, shift_pad=shift_pad)

    # multi-view photoconsistency refinement in disparity space
    baselines, b0 = array_baselines(cameras, ref_index, src_indices)
    f_px = float(np.broadcast_to(cameras.host().fx, (n,))[ref_index])
    disparity = depth_to_disparity(sweep.depth, b0, f_px)
    refined = disparity
    rcfg = cfg.refine
    # static disparity ceiling of the candidate stack: the nearest plane plus
    # the largest accumulated refinement offsets
    d_ceiling = f_px * b0 / cfg.plane_sweep.z_near + (
        abs(rcfg.radius * rcfg.step) + 0.5 * abs(rcfg.step)) * max(rcfg.iterations, 1)
    ref_img, aux = images[ref_index], images[list(src_indices)]
    for _ in range(max(rcfg.iterations, 0)):
        refined = multiview_refine(ref_img, aux, baselines, refined, mask=mask & sweep.valid,
                                   radius=rcfg.radius, step=rcfg.step, window=rcfg.window,
                                   subpixel=rcfg.subpixel, max_disparity=d_ceiling).disparity
    refined_depth = torch.where(sweep.valid, disparity_to_depth(refined, b0, f_px), 0.0)
    return ArrayPipelineOutput(depth=sweep.depth, refined_depth=refined_depth,
                               disparity=disparity, refined_disparity=refined,
                               valid=sweep.valid, mask=mask, sweep=sweep)
