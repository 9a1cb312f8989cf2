"""Midpoint triangulation of grouped observations (twin of
``stereovisionarray_tpu/sfm/triangulate.py``).

For rays (C_i, d_i) the least-squares point solves
``sum_i (I - d_i d_i^T) X = sum_i (I - d_i d_i^T) C_i``: a 3x3 solve per
point, batched over every track, with the per-point sums of
:class:`~stereovisionarray_tpu_torch.sfm.segments.Segments` (deterministic)
and ``solve_ex`` (no host read on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.lie import matvec3
from stereovisionarray_tpu_torch.sfm.segments import Segments, host_indices

__all__ = ["reprojection_errors", "triangulate_midpoint"]


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices by cofactors along the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def _on(cameras: CameraArray, idx) -> CameraArray:
    """The rig gathered at host indices (copied to its device once, pinned)."""
    return cameras[host_to_device(host_indices(idx), cameras.fx.device)]


def triangulate_midpoint(cameras: CameraArray, cam_idx, uv: torch.Tensor, valid: torch.Tensor,
                         num_points: int, point_idx,
                         point_segments: Segments = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate ``num_points`` points from grouped observations.

    cam_idx, point_idx: (M,) host index arrays (camera and track of each
    observation); uv: (M, 2) pixels; valid: (M,) bool. ``point_segments``:
    the layout of point_idx, when the caller has built it. Returns (points
    (P, 3), ok (P,) bool: at least 2 valid rays and a well-conditioned
    normal system)."""
    segs = point_segments or Segments(point_idx, num_points, uv.device)
    cams = _on(cameras, cam_idx)
    dirs = cams.rays_each(uv)
    centers = -matvec3(cams.R.transpose(-1, -2), cams.t)
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    P_m = eye - dirs[:, :, None] * dirs[:, None, :]
    w = valid.to(dirs.dtype)
    A = segs.sum(P_m * w[:, None, None])
    b = segs.sum(matvec3(P_m, centers) * w[:, None])
    n_rays = segs.sum(valid.to(torch.int32))
    A_safe = A + 1e-9 * eye  # damped: padding rows (A = 0) stay finite
    X = torch.linalg.solve_ex(A_safe, b[..., None])[0][..., 0]
    ok = (n_rays >= 2) & (_det3(A_safe) > 1e-9)
    return X, ok


def reprojection_errors(cameras: CameraArray, points: torch.Tensor, cam_idx, point_idx,
                        uv: torch.Tensor) -> torch.Tensor:
    """(M, 2) pixel residuals of each observation (projection - measurement)."""
    pi = host_to_device(host_indices(point_idx), points.device)
    proj, _ = _on(cameras, cam_idx).project_each(points[pi])
    return proj - uv
