"""SO(3) / SE(3) exponential and logarithm maps (Rodrigues), batched (twin of
``stereovisionarray_tpu/geometry/lie.py``).

Bundle adjustment and the pose graph parameterize rotations by 3-vectors.
Every function broadcasts over leading batch dims and is differentiable:
near theta = 0 a Taylor series takes over, and every division guarded by a
``torch.where`` sees a safe denominator in the branch it does not take, so
forward- and reverse-mode derivatives stay finite at delta = 0.

The 3x3 products are written out as elementwise products and sums
(:func:`matmul3`, :func:`matvec3`): they never reach cuBLAS, so a caller's
TF32 setting cannot touch them, and they are one fused expression instead of
a batched GEMM of tiny matrices.
"""

from __future__ import annotations

import torch

__all__ = ["matmul3", "matvec3", "so3_exp", "so3_log", "se3_exp", "se3_log"]

_EPS = 1e-8
# Taylor-switch angle for series whose closed forms cancel in float32
_SMALL_ANGLE = 0.1


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as elementwise products, summed in index order."""
    return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as elementwise products, summed in index order."""
    return a[..., 0] * v[..., 0, None] + a[..., 1] * v[..., 1, None] + a[..., 2] * v[..., 2, None]


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _sinc(theta, theta2, theta2_safe):
    """sin(t)/t with the exact limit 1 at t = 0."""
    return torch.where(theta2 < _EPS, 1.0 - theta2 / 6.0,
                       torch.sin(theta) / torch.sqrt(theta2_safe))


def _one_minus_cos_over_t2(theta):
    """(1 - cos t)/t^2 through the half-angle identity 0.5 (sin(t/2)/(t/2))^2,
    free of cancellation for every t."""
    half = 0.5 * theta
    half_safe = torch.clamp(half, min=_EPS)
    s = torch.where(half < _EPS, 1.0 - half * half / 6.0, torch.sin(half_safe) / half_safe)
    return 0.5 * s * s


def _angle(w):
    theta2 = torch.sum(w * w, dim=-1)
    # a where-guarded division must never see a zero denominator, or the
    # branch not taken poisons the derivative with 0 * inf = NaN
    theta2_safe = torch.clamp(theta2, min=_EPS * _EPS)
    return theta2, theta2_safe, torch.sqrt(theta2_safe)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta2, theta2_safe, theta = _angle(w)
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    W = _hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * matmul3(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-4
    sin_safe = torch.where(small, 1.0, torch.sin(theta))
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    return scale[..., None] * v


def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) = (w, v) -> (R (..., 3, 3), t (..., 3))."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2, theta2_safe, theta = _angle(w)
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    # (1 - sin t / t)/t^2: the closed form cancels below ~0.1 rad in float32
    c = torch.where(theta < _SMALL_ANGLE,
                    1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (1.0 - a) / theta2_safe)
    W = _hat(w)
    eye, WW = _eye_like(W), matmul3(W, W)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return R, matvec3(V, v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist (..., 6) = (w, v)."""
    w = so3_log(R)
    theta2, theta2_safe, theta = _angle(w)
    W = _hat(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2; 1 - a/(2b) ~ theta^2/12
    # cancels entirely in float32 below ~0.1 rad, so the series is mandatory
    # there, and b comes from the half-angle form (never exactly 0 near 1e-3)
    a = _sinc(theta, theta2, theta2_safe)
    b = _one_minus_cos_over_t2(theta)
    coef = torch.where(theta < _SMALL_ANGLE,
                       1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                       (1.0 - a / (2.0 * torch.clamp(b, min=_EPS))) / theta2_safe)
    V_inv = _eye_like(W) - 0.5 * W + coef[..., None, None] * matmul3(W, W)
    return torch.cat([w, matvec3(V_inv, t)], dim=-1)
