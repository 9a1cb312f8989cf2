"""View warps, plain PyTorch (twin of ``stereovisionarray_tpu/ops/warp.py``).

:func:`bilinear_sample` is four edge-clipped gathers and a lerp in the
reference's operation order; :func:`homography_warp` applies one 3x3
homography to the pixel grid (the general-rig plane sweep);
:func:`warp_with_disparity` samples a source along its epipolar direction
(the refinement's warp); :func:`splat_depth` forward-splats a depth map with
a min-z scatter, so the nearest surface wins whatever the order of the points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["bilinear_sample", "homography_warp", "splat_depth", "warp_with_disparity"]


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor,
                    fill: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (H, W) `image` at float coords (..., 2) in uv order (u = column).
    Returns (values (...), in_bounds (...)); out-of-bounds samples get `fill`."""
    h, w = image.shape[-2:]
    u, v = coords[..., 0], coords[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)

    def gather(yi, xi):
        return image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    top = gather(v0i, u0i) * (1.0 - fu) + gather(v0i, u0i + 1) * fu
    bot = gather(v0i + 1, u0i) * (1.0 - fu) + gather(v0i + 1, u0i + 1) * fu
    val = top * (1.0 - fv) + bot * fv
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    return torch.where(inb, val, fill), inb


def pixel_grid(h: int, w: int, device, dtype=torch.float32):
    """(v, u) float row and column index grids of shape (H, W)."""
    v = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return v, u


def homography_warp(image: torch.Tensor, H: torch.Tensor,
                    out_shape: Optional[Tuple[int, int]] = None,
                    fill: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp `image` into the reference frame through H (3, 3), which maps
    reference pixels to source pixels. Returns (warped, valid)."""
    ho, wo = out_shape if out_shape is not None else image.shape[-2:]
    v, u = pixel_grid(ho, wo, image.device, image.dtype)
    src = torch.einsum("ij,jhw->ihw", H.to(image.dtype), torch.stack([u, v, torch.ones_like(u)]))
    z = src[2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    coords = torch.stack([src[0] * inv_z, src[1] * inv_z], dim=-1)
    return bilinear_sample(image, coords, fill=fill)


def warp_with_disparity(image: torch.Tensor, disparity: torch.Tensor, baseline_uv,
                        fill: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dst(y, x) = src(y + d*uy, x + d*ux)``, bilinear; pixels with
    disparity <= 0 or out of bounds are `fill` (valid False).
    `baseline_uv`: (2,) direction, a tensor or a pair of floats."""
    h, w = image.shape
    v, u = pixel_grid(h, w, disparity.device, disparity.dtype)
    coords = torch.stack([u + disparity * baseline_uv[0], v + disparity * baseline_uv[1]], dim=-1)
    val, inb = bilinear_sample(image, coords, fill=fill)
    ok = inb & (disparity > 0)
    return torch.where(ok, val, fill), ok


def splat_depth(depth: torch.Tensor, shift_uv: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Forward-splat an (H, W) depth map by per-pixel shifts (H, W, 2) (u, v),
    rounded half to even, keeping the smallest depth that lands on a pixel;
    `fill` where none lands. Pixels with depth <= 0 or landing off the image
    go to an extra bucket that is dropped."""
    h, w = depth.shape
    v, u = pixel_grid(h, w, depth.device, shift_uv.dtype)
    tu = torch.round(u + shift_uv[..., 0]).to(torch.int64)
    tv = torch.round(v + shift_uv[..., 1]).to(torch.int64)
    inb = (tu >= 0) & (tu < w) & (tv >= 0) & (tv < h) & (depth > 0)
    flat_idx = torch.where(inb, tv * w + tu, h * w)  # out-of-bounds bucket at the end
    big = torch.finfo(depth.dtype).max
    src = torch.where(inb, depth, big).reshape(-1)
    out = torch.full((h * w + 1,), big, dtype=depth.dtype, device=depth.device)
    out = out.scatter_reduce(0, flat_idx.reshape(-1), src, "amin")[:-1].reshape(h, w)
    return torch.where(out == big, fill, out)
