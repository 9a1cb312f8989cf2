"""Point-cloud <-> depth-map converters (twin of
``stereovisionarray_tpu/geometry/pointcloud.py``): a dense backprojection of
a depth map, and a z-buffered projection of points, a min-scatter so the
nearest point wins at each pixel whatever the order of the points. Invalid
pixels and points are explicit (`mask` in, `valid` out)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stereovisionarray_tpu_torch.geometry.camera import CameraArray

__all__ = ["depth_map_to_points", "point_cloud_colors", "points_to_depth_map"]


def depth_map_to_points(camera: CameraArray, depth: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        min_depth: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backproject an (H, W) z-depth map of one camera to world points:
    (points (H, W, 3), valid (H, W)); valid is depth > min_depth and `mask`."""
    h, w = depth.shape
    v = torch.arange(h, device=depth.device)[:, None].expand(h, w)
    u = torch.arange(w, device=depth.device)[None, :].expand(h, w)
    uv = torch.stack([u, v], dim=-1).to(depth.dtype)  # (H, W, 2) pixel centres
    pts = camera.backproject(uv.reshape(-1, 2), depth.reshape(-1)).reshape(h, w, 3)
    valid = depth > min_depth
    if mask is not None:
        valid = valid & mask
    return pts, valid


def points_to_depth_map(camera: CameraArray, points: torch.Tensor, resolution: Tuple[int, int],
                        valid: Optional[torch.Tensor] = None, fill: float = 0.0) -> torch.Tensor:
    """Project (N, 3) world points into one camera and keep the smallest
    camera-frame depth at each pixel they land on (coordinates rounded half to
    even); `fill` where none lands. Points behind the camera, off the image
    or not `valid` go to an extra bucket that is dropped."""
    h, w = resolution
    uv, z = camera.project(points)
    ui = torch.round(uv[..., 0]).to(torch.int64)
    vi = torch.round(uv[..., 1]).to(torch.int64)
    ok = (z > 0) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    if valid is not None:
        ok = ok & valid
    flat = torch.where(ok, vi * w + ui, h * w)
    zbuf = torch.full((h * w + 1,), float("inf"), dtype=z.dtype, device=z.device)
    zbuf = zbuf.scatter_reduce(0, flat, torch.where(ok, z, float("inf")), "amin")
    depth = zbuf[: h * w].reshape(h, w)
    return torch.where(torch.isfinite(depth), depth, fill)


def point_cloud_colors(image: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-point colours of a depth-map cloud: an (H, W) gray or (H, W, 3)
    RGB image as (H*W, 3) uint8, zeros where ~valid."""
    img = torch.stack([image] * 3, dim=-1) if image.dim() == 2 else image
    img = torch.where(valid[..., None], img, 0)
    return torch.clamp(img, 0, 255).to(torch.uint8).reshape(-1, 3)
