"""Plane-depth hypotheses and epipolar candidates (twin of
``stereovisionarray_tpu/geometry/epipolar.py``).

The plane depths feed ``floor()`` in the plane-sweep warp, so they must equal
the reference's bit for bit. ``torch.linspace`` rounds differently from
``jnp.linspace`` (and uses a two-sided formula on CUDA), so the depths are
computed on the host in numpy float32 with the reference's own arithmetic and
only then moved to a device. :func:`epipolar_candidates` gives every
reference pixel's match in a source view at each depth, the whole grid at
once (the original program walks each pixel's epipolar segment with
Bresenham); the plane sweep never builds them (K8 warps by shifts and
homographies), they serve tests and general geometry.
"""

from __future__ import annotations

import functools
from fractions import Fraction

from typing import Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.geometry.camera import CameraArray

__all__ = ["epipolar_candidates", "inverse_depth_samples", "rectified_shift_candidates"]


def _round_f32(x: Fraction) -> np.float32:
    """`x` rounded to the nearest float32, ties to even."""
    near = np.float32(float(x))
    cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.int32)) & 1))


def _fma_f32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add ``round(a * b + c)``, computed exactly."""
    b = Fraction(float(b))
    return np.array([_round_f32(Fraction(float(x)) * b + Fraction(float(z)))
                     for x, z in zip(a, c)], dtype=np.float32)


def inverse_depth_samples(z_near: float, z_far: float, num: int) -> np.ndarray:
    """(num,) float32 depths uniform in inverse depth, near -> far (a fresh
    copy of :func:`_inverse_depth_samples`, which is cached: its exact
    arithmetic costs about a millisecond of host time for 128 planes)."""
    return _inverse_depth_samples(float(z_near), float(z_far), int(num)).copy()


@functools.lru_cache(maxsize=64)
def _inverse_depth_samples(z_near: float, z_far: float, num: int) -> np.ndarray:
    """The depths, computed.

    ``jnp.linspace(1/z_near, 1/z_far, num, dtype=float32)`` writes
    ``start * (1 - i/div) + stop * (i/div)`` for i < div = num - 1 and appends
    ``stop``. XLA compiles that as ``c = 1/div`` (division by a constant
    becomes a product), ``start * (1 - i*c)``, and the sum as one fused
    multiply-add ``fma(i, stop*c, start * (1 - i*c))``; every step here is
    that float32 operation (for num <= 32 the compiled loop contracts element
    1 the other way, ``fma(start, 1 - c, stop*c)``, and so does this). The
    depths are ``1 / inv`` in float32."""
    start = np.float32(1.0 / z_near)
    stop = np.float32(1.0 / z_far)
    if num > 1:
        div = num - 1
        c = np.float32(1.0) / np.float32(div)
        i = np.arange(div, dtype=np.float32)
        inv = np.append(_fma_f32(i, stop * c, start * (np.float32(1.0) - i * c)), stop)
        if 2 < num <= 32:
            inv[1] = _fma_f32(np.array([start]), np.float32(1.0) - c, np.array([stop * c]))[0]
    else:
        inv = np.full((num,), start, dtype=np.float32)
    return np.float32(1.0) / inv.astype(np.float32)


def epipolar_candidates(cameras: CameraArray, ref: int, src: int, resolution: Tuple[int, int],
                        depths) -> torch.Tensor:
    """(D, H, W, 2) source-view pixel coordinates (u, v) of every reference
    pixel backprojected from camera `ref` at each of the D depths and
    projected into camera `src`, on the cameras' device; D leads, so one
    depth's candidates are a contiguous slab."""
    h, w = resolution
    cam_ref, cam_src = cameras[ref], cameras[src]
    device = cam_ref.fx.device
    z = torch.as_tensor(depths, dtype=torch.float32, device=device).reshape(-1)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    uv = torch.stack([u, v], dim=-1)  # (H, W, 2) pixel centres
    D = z.shape[0]
    pts = cam_ref.backproject(uv.expand(D, h, w, 2), z[:, None, None].expand(D, h, w))
    return cam_src.project(pts)[0]


def rectified_shift_candidates(width: int, num_disparities: int, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """(D, W) source columns of a rectified pair, ``x_src = x - d``: the
    degenerate epipolar geometry of the two-view path, whose candidates are
    never built."""
    x = torch.arange(width, dtype=dtype, device=device)[None, :]
    d = torch.arange(num_disparities, dtype=dtype, device=device)[:, None]
    return x - d
