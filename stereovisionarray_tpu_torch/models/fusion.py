"""Multi-view depth fusion: geometric-consistency filtering of per-view depth
maps into one deduplicated, confidence-weighted point cloud (twin of
``stereovisionarray_tpu/models/fusion.py``).

A depth estimate survives only if enough other views, reprojected through
their own depth maps, agree on the same surface point; each surface point is
kept in the lowest-indexed qualified view that sees it, at the mean of the
agreeing views' depths. The pair check loops over source views j and checks
every view i against j at once (a batched projection and one bilinear
sample), on the depths' device. Plain PyTorch: no TPU kernel stands behind
it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.ops.warp import bilinear_sample

__all__ = ["FusionResult", "depth_normals", "fuse_depth_maps", "fused_point_cloud",
           "reconstruct_array"]


class FusionResult(NamedTuple):
    """Per-source-pixel fusion outputs, (N, H, W) shapes; a flat cloud comes
    from :func:`fused_point_cloud`."""

    points: torch.Tensor  # (N, H, W, 3) world points at the fused depth
    valid: torch.Tensor  # (N, H, W) kept after consistency and dedup
    depth: torch.Tensor  # (N, H, W) consistency-averaged depth
    support: torch.Tensor  # (N, H, W) int32: views agreeing, self included
    confidence: torch.Tensor  # (N, H, W) support / N in [0, 1]


def _pixel_grid(h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
    """(H*W, 2) pixel coordinates in (u, v) order, row-major."""
    v = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return torch.stack([u, v], dim=-1).reshape(-1, 2)


def fuse_depth_maps(cameras: CameraArray, depths: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, *, rel_thresh: float = 0.01,
                    min_support: int = 3, min_depth: float = 1e-6, dedup: bool = True,
                    average: bool = True) -> FusionResult:
    """Fuse N per-view (N, H, W) z-depth maps into consistency-filtered world
    points.

    valid: optional (N, H, W) bool beside depth > min_depth. View j supports
    view i's pixel when ``|d_j(proj) - z_ij| <= rel_thresh * z_ij``.
    min_support: agreeing views needed, the source view included. dedup: a
    surface point stays only in the lowest-indexed qualified view that sees
    it. average: each kept depth becomes the mean of the agreeing views'
    estimates, reprojected into the source camera. ``points`` are garbage
    where ``~valid``."""
    n, h, w = depths.shape
    p = h * w
    f32 = torch.float32
    dev = depths.device
    depths = depths.to(f32)
    base_valid = depths > min_depth
    if valid is not None:
        base_valid = base_valid & valid
    dflat = torch.where(base_valid, depths, 0.0).reshape(n, p)
    vflat = base_valid.reshape(n, p)

    uv = _pixel_grid(h, w, dev).expand(n, p, 2)
    pts = cameras.backproject(uv, dflat)  # (N, P, 3) world points of every view
    depth_maps = dflat.reshape(n, h, w)
    iidx = torch.arange(n, dtype=torch.int32, device=dev)[:, None]  # (N, 1) source view ids

    def sweep(validf):
        """Over source views j: per (view i, pixel) the count of other
        agreeing views, the sum of their depth estimates and the smallest
        agreeing view index. `validf` (N, H, W) float gates which of view j's
        pixels may vouch (bilinear > 0.99)."""
        support = torch.zeros((n, p), dtype=torch.int32, device=dev)
        depth_sum = torch.zeros((n, p), dtype=f32, device=dev)
        first_j = torch.full((n, p), n, dtype=torch.int32, device=dev)
        for j in range(n):
            cam_j = cameras[j]
            uv_ij, z_ij = cam_j.project(pts)  # every view's points in view j: (N, P)
            dj, inb = bilinear_sample(depth_maps[j], uv_ij, fill=0.0)
            vj, _ = bilinear_sample(validf[j], uv_ij, fill=0.0)
            agree = (inb & (z_ij > min_depth) & (dj > min_depth) & (vj > 0.99)
                     & ((dj - z_ij).abs() <= rel_thresh * z_ij))
            other = agree & (iidx != j)  # self-agreement is counted separately
            # view j's estimate of view i's pixel, as a z in camera i
            z_back = cameras.world_to_cam(cam_j.backproject(uv_ij, dj))[..., 2]
            support = support + other.to(torch.int32)
            depth_sum = depth_sum + torch.where(other, z_back, 0.0)
            first_j = torch.minimum(first_j, torch.where(other, j, n).to(torch.int32))
        return support, depth_sum, first_j

    support, depth_sum, _ = sweep(vflat.to(f32).reshape(n, h, w))
    support_total = support + 1  # self included
    keep = vflat & (support_total >= min_support)
    if dedup:
        # first qualified view wins: ownership is decided among views that
        # pass the support test themselves, so the owner keeps its point
        _, _, first_j = sweep(keep.to(f32).reshape(n, h, w))
        keep = keep & (first_j >= iidx)
    fused = (dflat + depth_sum) / support_total.to(f32) if average else dflat
    fused = torch.where(keep, fused, 0.0)
    pts_out = cameras.backproject(uv, fused)
    conf = support_total.to(f32) / float(n)
    return FusionResult(points=pts_out.reshape(n, h, w, 3), valid=keep.reshape(n, h, w),
                        depth=fused.reshape(n, h, w), support=support_total.reshape(n, h, w),
                        confidence=torch.where(keep, conf, 0.0).reshape(n, h, w))


def fused_point_cloud(result: FusionResult, colors: Optional[torch.Tensor] = None
                      ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Flatten a :class:`FusionResult` on the host: (points (M, 3),
    confidence (M,), colors (M,) or None) of the valid entries."""
    mask = result.valid.cpu().numpy().reshape(-1)
    pts = result.points.cpu().numpy().reshape(-1, 3)[mask]
    conf = result.confidence.cpu().numpy().reshape(-1)[mask]
    col = None if colors is None else np.asarray(
        colors.cpu() if isinstance(colors, torch.Tensor) else colors).reshape(-1)[mask]
    return pts, conf, col


def reconstruct_array(images: torch.Tensor, cameras: CameraArray, cfg=None,
                      view_indices: Optional[Tuple[int, ...]] = None, *, use_roi: bool = False,
                      rel_thresh: float = 0.01, min_support: int = 3, dedup: bool = True,
                      min_confidence: float = 0.0, backend: str = "auto"
                      ) -> Tuple[FusionResult, torch.Tensor]:
    """Per-view depth maps fused into one cloud: ``array_depth_pipeline`` with
    each entry of `view_indices` (default every view) as the reference, then
    :func:`fuse_depth_maps`. min_confidence > 0 drops pixels whose PKRN
    confidence is below it before they can vote. `backend` is the pipeline's
    (``array_depth_pipeline``). Returns (FusionResult over the selected
    views, depths (V, H, W))."""
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.models.array_pipeline import array_depth_pipeline

    if cfg is None:
        cfg = EngineConfig()
    if view_indices is None:
        view_indices = tuple(range(images.shape[0]))
    depths, valids = [], []
    for ref in view_indices:
        out = array_depth_pipeline(images, cameras, cfg, ref_index=int(ref), use_roi=use_roi,
                                   backend=backend)
        valid = out.valid
        if min_confidence > 0.0 and out.sweep.confidence is not None:
            valid = valid & (out.sweep.confidence >= min_confidence)
        depths.append(out.refined_depth)
        valids.append(valid)
    depths = torch.stack(depths)
    result = fuse_depth_maps(cameras[[int(i) for i in view_indices]], depths,
                             valid=torch.stack(valids), rel_thresh=rel_thresh,
                             min_support=min_support, dedup=dedup)
    return result, depths


def depth_normals(cameras: CameraArray, depth: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space surface normals of one view's (H, W) depth map: central
    differences of the backprojected points, normal = normalize(dp/du x
    dp/dv), turned toward the camera. Returns (normals (H, W, 3), valid
    (H, W)); a pixel whose 4-neighbourhood holds an invalid pixel, and the
    1-pixel frame, are invalid."""
    h, w = depth.shape
    uv = _pixel_grid(h, w, depth.device, depth.dtype)
    pts = cameras.backproject(uv, depth.reshape(-1)).reshape(h, w, 3)
    ok = depth > 1e-6
    if valid is not None:
        ok = ok & valid
    du = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dv = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    nrm = torch.linalg.cross(du, dv)
    mag = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.where(mag < 1e-12, 1.0, mag)
    flip = (nrm * (cameras.centers - pts)).sum(dim=-1, keepdim=True) < 0  # toward the camera
    nrm = torch.where(flip, -nrm, nrm)
    ok4 = (ok & torch.roll(ok, -1, dims=1) & torch.roll(ok, 1, dims=1)
           & torch.roll(ok, -1, dims=0) & torch.roll(ok, 1, dims=0))
    ok4[0, :] = ok4[-1, :] = False  # the rolls wrap at the border
    ok4[:, 0] = ok4[:, -1] = False
    return torch.where(ok4[..., None], nrm, 0.0), ok4
