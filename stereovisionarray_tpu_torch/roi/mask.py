"""Geometric ROI masks on a pixel grid (twin of
``stereovisionarray_tpu/roi/mask.py``).

:func:`ellipse_mask` is the reference's ``getFaceCircle`` gate,
:func:`convex_polygon_mask` its ``fillConvexPoly`` (one sign test per edge
and pixel), :func:`face_mask_from_landmarks` the vertex recipe over the jaw
contour 0-16 and the brow points 24 and 19, and
:func:`face_ellipse_from_landmarks` the ellipse from landmarks 0, 16 and 8.
Every mask is a bool tensor on the device of its geometry.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["convex_polygon_mask", "ellipse_mask", "face_ellipse_from_landmarks",
           "face_mask_from_landmarks"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _grid(shape: Tuple[int, int], device):
    h, w = shape
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return v, u


def ellipse_mask(shape: Tuple[int, int], center, axes, angle=0.0, device=None) -> torch.Tensor:
    """(H, W) bool mask of an ellipse. center (2,) (u, v); axes (2,)
    semi-axes (a along the rotated u axis, b along v); angle in radians,
    counter-clockwise. `device` defaults to `center`'s."""
    if device is None:
        device = center.device if isinstance(center, torch.Tensor) else "cpu"
    center, axes, angle = _f32(center, device), _f32(axes, device), _f32(angle, device)
    v, u = _grid(shape, device)
    du, dv = u - center[0], v - center[1]
    ca, sa = torch.cos(angle), torch.sin(angle)
    x = du * ca + dv * sa
    y = -du * sa + dv * ca
    a = torch.clamp(axes[0], min=1e-6)
    b = torch.clamp(axes[1], min=1e-6)
    return (x / a) ** 2 + (y / b) ** 2 <= 1.0


def convex_polygon_mask(shape: Tuple[int, int], vertices: torch.Tensor) -> torch.Tensor:
    """(H, W) bool mask of a convex polygon with (K, 2) (u, v) vertices in
    either winding: a pixel is inside when every edge's cross product has one
    sign."""
    vertices = torch.as_tensor(vertices, dtype=torch.float32)
    v, u = _grid(shape, vertices.device)
    p0, p1 = vertices, torch.roll(vertices, -1, dims=0)
    ex = (p1[:, 0] - p0[:, 0])[:, None, None]
    ey = (p1[:, 1] - p0[:, 1])[:, None, None]
    px = u[None] - p0[:, 0][:, None, None]
    py = v[None] - p0[:, 1][:, None, None]
    cross = ex * py - ey * px
    return (cross >= 0.0).all(dim=0) | (cross <= 0.0).all(dim=0)


def face_mask_from_landmarks(shape: Tuple[int, int], landmarks: torch.Tensor) -> torch.Tensor:
    """Face mask from 68-point (u, v) landmarks: the convex polygon of the
    jaw contour (0-16) and the brow points 24 and 19."""
    poly = torch.cat([landmarks[0:17], landmarks[24:25], landmarks[19:20]], dim=0)
    return convex_polygon_mask(shape, poly)


def face_ellipse_from_landmarks(landmarks: torch.Tensor):
    """(center (2,), axes (2,), angle): width from landmarks 0 and 16, the
    chin at 8, the centre 0.75 / 0.25 between the ear line and the chin, the
    height 1.7x the half-width."""
    left, right, chin = landmarks[0], landmarks[16], landmarks[8]
    width = torch.linalg.vector_norm(right - left)
    mid = 0.5 * (left + right)
    center = 0.75 * mid + 0.25 * chin
    a = 0.5 * width
    b = 0.5 * 1.7 * width
    angle = torch.atan2(right[1] - left[1], right[0] - left[0])
    return center, torch.stack([a, b]), angle
