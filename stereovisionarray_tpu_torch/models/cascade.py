"""Coarse-to-fine two-view stereo for large disparity ranges (twin of
``stereovisionarray_tpu/models/cascade.py``).

1. Coarse pass: both views area-downsampled by ``coarse_factor`` run the
   two-view pipeline at ``ceil(total / factor)`` disparities (rounded up to a
   multiple of 8, as the reference does), with a census window scaled down
   to the coarse resolution and median + speckle + hole-fill post-filters.
2. Pre-warp: the right view is warped toward the left by a field taken from
   the upsampled coarse map, so the fine pass searches only a
   ``fine_disparities``-wide residual window.
3. Fine pass: the two-view pipeline at ``fine_disparities`` (at most 4 SGM
   paths) on (left, warped right); the total disparity is the fine one plus
   the warp's shift field sampled where the match landed.

``mode="smooth"`` warps by the continuous, slope-compensated field
``s* = g(x) + r(x, y)``: ``g`` (the column mean of s*) by a per-column
two-tap gather, the residual ``r`` (clamped to ±``SMOOTH_R``) by the
hat-sampling kernel K9, which also samples ``g`` with the same weights to
give the exact realised field ``s_eff``; the decode samples ``s_eff`` with
K9 again. ``mode="band"`` quantises the field to integer bands of
``band_step`` and warps and decodes by gathers. ``band_offset`` is float32
in both modes (the reference documents int32 for band mode and returns
float32).

Every step the reference takes that changes outputs is kept: the coarse
census window, the multiple-of-8 coarse range, the coarse post-filters, 4
paths on the fine pass, the decoded map's median + speckle pass and the
edge-capped confidence. The float glue runs without fused multiply-adds and
in PyTorch's summation order, so against the reference on the CPU it agrees
to the last bits rather than exactly; on the card the kernel route and the
plain route run the same glue and agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
from stereovisionarray_tpu_torch.models.cascade_sweep import (
    area_downsample,
    box_mean,
    pad_to_multiple,
)
from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth, two_view_disparity
from stereovisionarray_tpu_torch.ops.hatsample import hat_sample
from stereovisionarray_tpu_torch.ops.postfilter import median3x3, speckle_filter
from stereovisionarray_tpu_torch.ops.wta import INVALID_DISPARITY

__all__ = ["CascadeOutput", "SMOOTH_R", "cascade_two_view_disparity"]

# the reference's residual half-range (tap count 2 * SMOOTH_R + 1), tuned at 540x768
SMOOTH_R = 36


class CascadeOutput(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32 in the full range, INVALID_DISPARITY invalid
    valid: torch.Tensor  # (H, W) bool
    cost: torch.Tensor  # (H, W) fine-pass winning cost
    depth: Optional[torch.Tensor] = None
    confidence: Optional[torch.Tensor] = None  # fine-pass PKRN, edge-capped
    coarse_disparity: Optional[torch.Tensor] = None  # (H, W) upsampled coarse map, px
    band_offset: Optional[torch.Tensor] = None  # (H, W) float32: band starts or s_eff


@functools.lru_cache(maxsize=32)
def _linear_resize_weights(m: int, n: int) -> np.ndarray:
    """(m, n) float32 weights of ``jax.image.resize(method="linear")`` from m
    to n samples: a triangle kernel at half-pixel centres (widened by the
    scale when shrinking, the antialiased default), each output's weights
    renormalised to sum to one, zero for samples outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))  # the reference's Python-float scale, rounded once
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    wts = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """Twin of ``jax.image.resize(x, shape, method="linear")`` for an (h, w)
    map: the reference's weight matrices, contracted as matrix products
    (rows, then columns); an axis whose size does not change is left alone."""
    out = x
    if shape[0] != x.shape[0]:
        wh = torch.from_numpy(_linear_resize_weights(x.shape[0], shape[0])).to(x.device)
        out = wh.T @ out
    if shape[1] != x.shape[1]:
        ww = torch.from_numpy(_linear_resize_weights(x.shape[1], shape[1])).to(x.device)
        out = out @ ww
    return out


def gradient(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Twin of ``jnp.gradient`` with unit spacing along `dim`: central
    differences ``(a[i+1] - a[i-1]) * 0.5`` inside, one-sided at the ends."""
    n = a.shape[dim]
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def convolve_same(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Twin of ``jnp.convolve(a, v, mode="same")`` for 1-D tensors:
    ``out[i] = sum_j a[i + (k - 1) // 2 - j] * v[j]``, zero outside, k =
    len(v); as there, the longer operand is the signal."""
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    k = v.shape[0]
    padded = torch.nn.functional.pad(a, (k // 2, k - 1 - k // 2))
    return (padded.unfold(0, k, 1) * v.flip(0)).sum(dim=-1)


def _column_warp(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``out(y, x)`` = bilinear ``img(y, pos(x))``, ``pos = clip(x - g[x], 0,
    W - 1)``: the reference's hat-matrix product (``cascade.py:137``) as a
    two-tap gather per column, the taps taken in ascending order."""
    w = img.shape[1]
    pos = (torch.arange(w, dtype=torch.float32, device=img.device) - g).clamp(0.0, w - 1.0)
    u0 = torch.floor(pos)
    u1 = u0 + 1.0
    w0 = (1.0 - (pos - u0).abs()).clamp_min(0.0)
    w1 = (1.0 - (pos - u1).abs()).clamp_min(0.0)
    i0 = u0.to(torch.int64)
    i1 = u1.to(torch.int64).clamp_max(w - 1)
    return img[:, i0] * w0 + img[:, i1] * w1


def _smooth_prewarp(right: torch.Tensor, s_star: torch.Tensor, smooth_r: int, backend: str):
    """Warp `right` by the smooth field `s_star` (``cascade.py:155``):
    ``wright(x) = v1(x - r(x))`` with ``v1(u) = right(u - g(u))``, ``g`` the
    column mean of s*, ``r = clip((s* - g) / (1 - g'), -R, R)``. Returns
    (wright, s_eff), s_eff the field the warp realised, clamping included."""
    R = int(smooth_r)
    g = s_star.mean(dim=0)
    box9 = torch.full((9,), 1.0, device=g.device) / 9.0
    gp = convolve_same(gradient(g), box9).clamp(-0.2, 0.7)
    r = ((s_star - g[None, :]) / (1.0 - gp[None, :])).clamp(-float(R), float(R))
    v1 = _column_warp(right, g)
    wright, g_samp = hat_sample(v1, r, -R, R, aux=g, backend=backend)
    return wright, r + g_samp


def _check_config(total: int, Df: int, q: int, mode: str) -> None:
    if total <= Df:
        raise ValueError("total range <= fine_disparities: use the flat pipeline")
    if Df % q or Df < 2 * q:
        raise ValueError("fine_disparities must be a multiple (>=2x) of band_step")
    if mode not in ("smooth", "band"):
        raise ValueError(f"unknown cascade mode {mode!r}")


def cascade_two_view_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    cost_cfg: CostConfig = CostConfig(num_disparities=256),
    sgm_cfg: SGMConfig = SGMConfig(),
    coarse_factor: int = 4,
    fine_disparities: int = 32,
    band_step: int = 8,
    baseline: Optional[float] = None,
    focal_px: Optional[float] = None,
    backend: str = "auto",
    mode: str = "smooth",
    slant_bias: float = 0.0,
    internal_paths: Optional[int] = 4,
    smooth_r: Optional[int] = None,
) -> CascadeOutput:
    """Large-range disparity of an (H, W) rectified pair by a coarse pass and
    a residual fine pass. ``cost_cfg.num_disparities`` is the total range;
    ``fine_disparities`` the per-pixel window of the fine pass.

    backend: "auto" (kernels for CUDA tensors, plain PyTorch for CPU
    tensors), "cuda" (kernels, CUDA tensors only) or "torch" (plain PyTorch
    on any device)."""
    total, s, Df, q = (int(cost_cfg.num_disparities), int(coarse_factor),
                       int(fine_disparities), int(band_step))
    _check_config(total, Df, q, mode)
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    H, W = left.shape

    # ---- coarse pass on the downsampled pair --------------------------------
    lp, rp = pad_to_multiple(left, s), pad_to_multiple(right, s)
    d_coarse = -(-total // s)
    d_coarse = -(-d_coarse // 8) * 8
    wh, ww = cost_cfg.census_window
    wh_c = max(5, (wh // 2) | 1)
    coarse_cost = dataclasses.replace(cost_cfg, num_disparities=d_coarse,
                                      census_window=(wh_c, max(wh_c + 2, (ww // 2) | 1)))
    coarse_sgm = dataclasses.replace(sgm_cfg, median_filter=True,
                                     speckle_window=max(sgm_cfg.speckle_window, 9),
                                     fill_holes=True)
    coarse = two_view_disparity(area_downsample(lp, s), area_downsample(rp, s), coarse_cost,
                                coarse_sgm, backend=backend)
    cd = torch.where(coarse.valid, coarse.disparity, 0.0) * float(s)
    up = resize_linear(cd, lp.shape)[:H, :W]

    # ---- pre-warp of the right view ------------------------------------------
    if mode == "smooth":
        up_f = box_mean(up, 9)
        gx = gradient(up_f, dim=1).clamp(0.0, 1.0)
        sigma = box_mean(gx, 25).clamp(0.0, 0.7)
        s_star = (up_f - 0.5 * Df * (1.0 - sigma) + slant_bias * 0.5 * Df * sigma).clamp(
            0.0, float(total - Df))
        wright, offset_field = _smooth_prewarp(
            right, s_star, smooth_r if smooth_r is not None else SMOOTH_R, backend)
    else:
        n_bands = -(-(total - Df) // q) + 1
        band = torch.round((up - 0.5 * Df) / q).to(torch.int32).clamp(0, n_bands - 1)
        start = torch.clamp_max(band * q, total - Df)
        x = torch.arange(W, device=left.device)
        wright = right.gather(1, (x - start).clamp(0, W - 1).to(torch.int64))
        offset_field = start.to(torch.float32)

    # ---- fine pass -------------------------------------------------------------
    fine_sgm = sgm_cfg
    if internal_paths is not None:
        fine_sgm = dataclasses.replace(sgm_cfg,
                                       num_paths=min(sgm_cfg.num_paths, int(internal_paths)))
    fine = two_view_disparity(left, wright.contiguous(),
                              dataclasses.replace(cost_cfg, num_disparities=Df), fine_sgm,
                              backend=backend)

    # ---- decode: the shift field sampled where the match landed ---------------
    if mode == "smooth":
        t = fine.disparity.clamp(0.0, Df - 1.0)
        off_at = hat_sample(offset_field.contiguous(), t, 0, Df - 1, backend=backend)
    else:
        df_round = torch.round(fine.disparity).to(torch.int64).clamp(0, Df - 1)
        x = torch.arange(W, device=left.device)
        off_at = offset_field.gather(1, (x - df_round).clamp(0, W - 1))
    disparity = torch.where(fine.valid, fine.disparity + off_at, INVALID_DISPARITY)
    valid = fine.valid
    if mode == "smooth":
        disparity = median3x3(disparity, valid)
        disparity, valid = speckle_filter(disparity, valid, max_diff=1.5, window=5,
                                          min_support=8)
        disparity = torch.where(valid, disparity, INVALID_DISPARITY)
    conf = fine.confidence
    if conf is not None:
        edge = (fine.disparity < 1.5) | (fine.disparity > Df - 2.5)
        conf = torch.where(valid, torch.where(edge, conf.clamp_max(0.05), conf), 0.0)

    depth = None
    if baseline is not None and focal_px is not None:
        depth = disparity_to_depth(torch.where(valid, disparity, 0.0), baseline, focal_px)
    return CascadeOutput(disparity=disparity, valid=valid, cost=fine.cost, depth=depth,
                         confidence=conf, coarse_disparity=up, band_offset=offset_field)
