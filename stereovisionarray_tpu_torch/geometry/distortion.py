"""Brown-Conrady lens distortion (twin of
``stereovisionarray_tpu/geometry/distortion.py``): distort and undistort
points, and resample images onto the ideal pinhole grid.

A capture through a real lens is undistorted once at ingest; the whole
pinhole stack (rectification, plane sweep, SfM) then applies unchanged.

Model (OpenCV's k1, k2, p1, p2 on normalized coordinates):
  r2 = x^2 + y^2,  radial = 1 + k1 r2 + k2 r2^2
  x_d = x radial + 2 p1 x y + p2 (r2 + 2 x^2)
  y_d = y radial + p1 (r2 + 2 y^2) + 2 p2 x y
Undistortion inverts it by a fixed number of fixed-point steps. The image
functions batch over views: (N, H, W) images with an (N,) rig resample every
view in one pass, where the reference loops over them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.ops.warp import bilinear_sample, pixel_grid

__all__ = ["Distortion", "distort_image", "distort_points", "undistort_image",
           "undistort_points"]


class Distortion(NamedTuple):
    """Brown-Conrady coefficients (floats or 0-dim tensors)."""

    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


def distort_points(xy: torch.Tensor, dist: Distortion) -> torch.Tensor:
    """Ideal normalized coords (..., 2) -> distorted normalized coords."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2
    xd = x * radial + 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(xy_d: torch.Tensor, dist: Distortion, iterations: int = 8) -> torch.Tensor:
    """Distorted normalized coords (..., 2) -> ideal coords by fixed-point
    steps x <- (x_d - tangential(x)) / radial(x), seeded at x_d."""
    xy = xy_d
    for _ in range(iterations):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2
        tx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        ty = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - tx) / radial, (xy_d[..., 1] - ty) / radial], dim=-1)
    return xy


def _intrinsics(cam: CameraArray, ndim: int):
    """fx, fy, cx, cy shaped to broadcast against (N, H, W) grids."""
    shape = tuple(cam.fx.shape) + (1,) * (ndim - cam.fx.dim())
    return (cam.fx.reshape(shape), cam.fy.reshape(shape), cam.cx.reshape(shape),
            cam.cy.reshape(shape))


def _resample(image: torch.Tensor, cam: CameraArray, warp) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample `image` (H, W) or (N, H, W) at warp(ideal normalized grid) of
    its camera (an unbatched or (N,) rig)."""
    h, w = image.shape[-2:]
    v, u = pixel_grid(h, w, image.device)
    fx, fy, cx, cy = _intrinsics(cam, image.dim())
    xy = torch.stack(torch.broadcast_tensors((u - cx) / fx, (v - cy) / fy), dim=-1)
    src = warp(xy)
    src = torch.stack([src[..., 0] * fx + cx, src[..., 1] * fy + cy], dim=-1)
    return bilinear_sample(image, src, fill=0.0)


def undistort_image(image: torch.Tensor, cam: CameraArray,
                    dist: Distortion) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample a distorted capture onto the ideal pinhole grid of `cam`: for
    each ideal pixel, normalize, distort and sample the capture bilinearly.
    image (H, W) with one camera, or (N, H, W) with an (N,) rig. Returns
    (image, valid), each of the image's shape."""
    return _resample(image, cam, lambda xy: distort_points(xy, dist))


def distort_image(image: torch.Tensor, cam: CameraArray, dist: Distortion,
                  iterations: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`undistort_image` (apply the lens to an ideal render):
    for each distorted pixel, undistort its coordinates and sample the ideal
    image."""
    return _resample(image, cam, lambda xy: undistort_points(xy, dist, iterations))
