"""Coarse-to-fine plane sweep over the camera array (twin of
``stereovisionarray_tpu/models/cascade_sweep.py``), for translation-only rigs.

1. Coarse pass: every view area-downsampled by ``coarse_factor`` runs
   :func:`plane_sweep_depth` at ``ceil(D / factor)`` planes (rounded up to a
   multiple of 8) on scaled intrinsics with a smaller census patch.
2. Plane-index field: median + speckle + background hole fill
   (``take="max"``: the index grows with depth) on the coarse winner, then
   upsampled to full resolution.
3. Pre-warp and fine pass: planes uniform in inverse depth give per-view
   shifts linear in the plane index, ``shift_v(j) = a_v + c_v * j``, so each
   source is warped by ``a_v + c_v * K(x)`` and the fine pass sweeps only the
   residual shifts ``c_v * j`` for ``j < fine_planes`` with the same kernels
   (K8, then K2/K3 and K4). ``mode="smooth"`` warps by the box-smoothed
   continuous field with two hat-sampling passes (K9: along rows, then along
   columns, every source in one launch of ``hat_sample_2d``); ``mode="band"``
   quantises the field to bands of ``band_step`` planes and warps each band
   by a uniform shift.
4. Decode: ``k = k_fine + K``; depth from the full plane range, and the view
   count recomputed in the original frame from the full shift.

The reference's approximations are kept as they are (the field is read at
the reference pixel, not at the match; the pre-warp is bilinear), so the
port's outputs are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.epipolar import inverse_depth_samples
from stereovisionarray_tpu_torch.models.plane_sweep import (
    PlaneSweepOutput,
    _shift_warp,
    _volume_to_maps,
    plane_sweep_depth,
    plane_sweep_volume,
    shifts_at_inverse_depths,
)
from stereovisionarray_tpu_torch.ops.hatsample import hat_sample_2d
from stereovisionarray_tpu_torch.ops.postfilter import fill_holes, median3x3, shifted, speckle_filter
from stereovisionarray_tpu_torch.ops.refine import box_filter2d
from stereovisionarray_tpu_torch.ops.sweep_cuda import reciprocal_f32

__all__ = [
    "area_downsample",
    "box_mean",
    "cascade_plane_sweep_depth",
    "cascade_static_params",
    "pad_to_multiple",
    "scale_cameras",
    "upsample_bilinear",
]


def scale_cameras(cameras: CameraArray, s: int) -> CameraArray:
    """Intrinsics of an s-fold area downsample: fine pixel u = s*u' + (s-1)/2,
    so fx' = fx / s, cx' = (cx - (s-1)/2) / s; extrinsics unchanged. The
    division is the product with the float32 reciprocal, as the reference's
    compiled division by a constant is."""
    half = (s - 1) / 2.0
    inv = reciprocal_f32(s)
    return CameraArray(fx=cameras.fx * inv, fy=cameras.fy * inv, cx=(cameras.cx - half) * inv,
                       cy=(cameras.cy - half) * inv, R=cameras.R, t=cameras.t)


def area_downsample(imgs: torch.Tensor, s: int) -> torch.Tensor:
    """(..., H, W) -> (..., H/s, W/s) area mean (H, W multiples of s). The
    s*s samples of a cell are summed in row-major order, the reference's
    order on the CPU, so the means are its means bit for bit."""
    h, w = imgs.shape[-2:]
    cells = imgs.reshape(*imgs.shape[:-2], h // s, s, w // s, s)
    acc = torch.zeros(cells.shape[:-3] + cells.shape[-2:-1], dtype=imgs.dtype, device=imgs.device)
    for i in range(s):
        for j in range(s):
            acc = acc + cells[..., i, :, j]
    return acc * reciprocal_f32(s * s)


def pad_to_multiple(imgs: torch.Tensor, s: int) -> torch.Tensor:
    """Edge-pad the trailing (H, W) axes up to multiples of s."""
    h, w = imgs.shape[-2:]
    ph, pw = (-h) % s, (-w) % s
    if not (ph or pw):
        return imgs
    rows = torch.arange(h + ph, device=imgs.device).clamp_max(h - 1)
    cols = torch.arange(w + pw, device=imgs.device).clamp_max(w - 1)
    return imgs[..., rows, :][..., cols]


def box_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean, normalised by the in-image count at the borders."""
    return box_filter2d(x, k) / box_filter2d(torch.ones_like(x), k)


def upsample_bilinear(k: torch.Tensor, s: int) -> torch.Tensor:
    """(h, w) -> (h*s, w*s) with half-pixel centres and edge clamp: fine
    phase p of each axis is ``lo * (1 - a) + hi * a`` of the edge-padded
    coarse samples, as the reference's slice-and-lerp form computes it."""
    def axis_up(x, axis):
        n = x.shape[axis]
        idx = torch.arange(-1, n + 1, device=x.device).clamp(0, n - 1)
        xp = x.index_select(axis, idx)
        phases = []
        for p in range(s):
            c = (p - (s - 1) / 2.0) / s
            b = 1 + int(np.floor(c))
            a = float(c - np.floor(c))
            lo, hi = xp.narrow(axis, b, n), xp.narrow(axis, b + 1, n)
            phases.append(lo * (1.0 - a) + hi * a)
        shape = list(x.shape)
        shape[axis] = n * s
        return torch.stack(phases, dim=axis + 1).reshape(shape)

    return axis_up(axis_up(k, 0), 1)


def cascade_static_params(cameras: CameraArray, ref_index: int, src_indices: Tuple[int, ...],
                          cfg: PlaneSweepConfig, fine_planes: int) -> tuple:
    """Host-side static parameters of :func:`cascade_plane_sweep_depth`, in
    the reference's float32 arithmetic: ``(band_offsets, fine_pad)``, the
    per-view integer (dy, dx) shifts that centre each view's read of the
    plane field on the fine window's midpoint, and a bound on the fine
    pass's residual shifts ``|c_v| * (fine_planes - 1)`` (for experiments;
    the pipeline reuses the full-range shift bound)."""
    host = cameras.host()
    t = host.t
    n = t.shape[0]
    fx = np.broadcast_to(host.fx, (n,))
    fy = np.broadcast_to(host.fy, (n,))
    d = max(cfg.num_planes - 1, 1)
    step_inv = (1.0 / cfg.z_far - 1.0 / cfg.z_near) / d
    offsets = []
    max_c = 0.0
    for s in (int(i) for i in src_indices):
        cu = fx[s] * (t[s, 0] - t[ref_index, 0]) * step_inv
        cv = fy[s] * (t[s, 1] - t[ref_index, 1]) * step_inv
        offsets.append((int(round(cv * fine_planes / 2)), int(round(cu * fine_planes / 2))))
        max_c = max(max_c, abs(cu), abs(cv))
    fine_pad = int(np.ceil(max_c * max(fine_planes - 1, 1))) + 2
    return tuple(offsets), fine_pad


def linear_shift_params(cameras: CameraArray, ref_index: int, src_indices, cfg: PlaneSweepConfig):
    """The full-range plane depths (D,) and the per-view shift intercepts
    ``a`` and steps ``c`` (S, 2) of ``shift_v(j) = a_v + c_v * j``, host
    float32. ``a`` and ``c`` read the end planes only, at their exact inverse
    depths ``1 / z_near`` and ``1 / z_far`` (the reference's compiled
    ``1 / (1 / x)`` is ``x``); ``c`` is ``(shift(D-1) - a) / (D-1)``, the
    division compiled as the product with the float32 reciprocal."""
    total = int(cfg.num_planes)
    ends = np.array([1.0 / cfg.z_near, 1.0 / cfg.z_far], dtype=np.float32)
    sh = shifts_at_inverse_depths(cameras, ref_index, [int(i) for i in src_indices], ends)
    a = sh[:, 0, :]
    c = (sh[:, 1, :] - a) * np.float32(reciprocal_f32(max(total - 1, 1)))
    return inverse_depth_samples(cfg.z_near, cfg.z_far, total), a, c.astype(np.float32)


def _coarse_band_prewarp(images, cameras, ref_index, src_indices, cfg: PlaneSweepConfig,
                         sgm_cfg, *, min_views, backend, shift_pad, coarse_factor, fine_planes,
                         band_step, band_offsets, mode="smooth"):
    """Coarse pass, plane-index field and per-view pre-warp: everything before
    the fine sweep. Returns (warped sources (S, H, W), the plane-index offset
    field (H, W) (band starts or the smooth field), a (S, 2), c (S, 2) host
    float32, and the full-range depths (D,) host float32)."""
    total, s, df, q = int(cfg.num_planes), int(coarse_factor), int(fine_planes), int(band_step)
    images = images.to(torch.float32)
    n, h, w = images.shape
    dev = images.device
    src = [int(i) for i in src_indices]
    src_images = torch.stack([images[i] for i in src])  # a list index would be copied to the card
    n_src = len(src)

    # ---- coarse pass on the downsampled rig ----------------------------------
    d_coarse = -(-total // s)
    d_coarse = -(-d_coarse // 8) * 8
    cfg_c = dataclasses.replace(cfg, num_planes=d_coarse, sources_8bit=False,
                                patch=max(3, (cfg.patch // s) | 1))
    coarse = plane_sweep_depth(area_downsample(pad_to_multiple(images, s), s),
                               scale_cameras(cameras, s), ref_index, src_indices, cfg_c, sgm_cfg,
                               min_views=min_views, backend=backend,
                               shift_pad=-(-shift_pad // s) + 2)
    kc = median3x3(coarse.plane, coarse.valid)
    kc, vc = speckle_filter(kc, coarse.valid, max_diff=2.0, window=5, min_support=8)
    kc, vc = fill_holes(kc, vc, take="max", max_span=32)
    kc = torch.where(vc, kc, (d_coarse - 1) / 2.0)
    ratio = (total - 1) / max(d_coarse - 1, 1)
    k_up = upsample_bilinear(kc * ratio, s)[:h, :w]

    # ---- per-pixel band starts ----------------------------------------------
    n_bands = -(-(total - df) // q) + 1
    band = torch.round((k_up - 0.5 * df) / q).to(torch.int32).clamp(0, n_bands - 1)
    offset = torch.clamp_max(band * q, total - df).to(torch.float32)

    depths_full, a, c = linear_shift_params(cameras, ref_index, src, cfg)
    pad = int(shift_pad) + 1
    if mode == "smooth":
        K_star = (box_mean(k_up, 9) - 0.5 * df).clamp(0.0, float(total - df))
        if band_offsets is not None:
            Kv = torch.stack([shifted(K_star, dy, dx) for dy, dx in band_offsets])
        else:
            Kv = K_star.expand(n_src, h, w)
        a_t = host_to_device(a, dev)[..., None, None]
        c_t = host_to_device(c, dev)[..., None, None]
        su = a_t[:, 0] + c_t[:, 0] * Kv
        sv = a_t[:, 1] + c_t[:, 1] * Kv
        # vertical pass along the rows, then horizontal: all sources, one launch
        warped = hat_sample_2d(src_images, (-sv).clamp(-pad, pad), (-su).clamp(-pad, pad), -pad,
                               pad, backend=backend)
        return warped, K_star, a, c, depths_full

    if band_offsets is not None:
        bv = torch.stack([shifted(band, dy, dx) for dy, dx in band_offsets])
    else:
        bv = band.expand(n_src, h, w)
    starts = np.array([min(b * q, total - df) for b in range(n_bands)], dtype=np.float32)
    band_shifts = a[None] + c[None] * starts[:, None, None]  # (n_bands, S, 2)
    padded = torch.nn.functional.pad(src_images, (pad, pad, pad, pad))
    per_band = _shift_warp(padded, host_to_device(band_shifts, dev), h, w, pad)
    wsrc = per_band.gather(0, bv.to(torch.int64)[None])[0]
    return wsrc, offset, a, c, depths_full


def cascade_plane_sweep_depth(
    images: torch.Tensor,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    sgm_cfg: Optional[SGMConfig] = SGMConfig(lr_max_diff=0.0),
    min_views: int = 2,
    mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
    shift_pad: int = 0,
    coarse_factor: int = 4,
    fine_planes: int = 48,
    band_step: int = 8,
    band_offsets: Optional[tuple] = None,
    fine_shift_pad: Optional[int] = None,
    mode: str = "smooth",
) -> PlaneSweepOutput:
    """Drop-in :func:`plane_sweep_depth` for large plane counts on a
    translation-only rig (``shift_pad > 0`` required). ``cfg.num_planes`` is
    the total range; the fine pass sweeps a per-pixel ``fine_planes``-wide
    window. ``band_offsets`` come from :func:`cascade_static_params`.

    backend: "auto" (kernels for CUDA tensors, plain PyTorch for CPU
    tensors), "cuda" (kernels, CUDA tensors only) or "torch" (plain PyTorch)."""
    total, df, q = int(cfg.num_planes), int(fine_planes), int(band_step)
    if shift_pad <= 0:
        raise ValueError("cascade_plane_sweep_depth requires the translation "
                         "fast path (shift_pad > 0)")
    if total <= df:
        raise ValueError("total planes <= fine_planes: use plane_sweep_depth")
    if df < 2 * q:
        raise ValueError("fine_planes must be >= 2*band_step (the window "
                         "must out-margin the band quantization)")
    if mode not in ("smooth", "band"):
        raise ValueError(f"unknown cascade mode {mode!r}")
    images = images.to(torch.float32)
    wsrc, offset, a, c, depths_full = _coarse_band_prewarp(
        images, cameras, ref_index, src_indices, cfg, sgm_cfg, min_views=min_views,
        backend=backend, shift_pad=shift_pad, coarse_factor=coarse_factor, fine_planes=df,
        band_step=q, band_offsets=band_offsets, mode=mode)
    n_src = len(src_indices)
    h, w = offset.shape
    dev = images.device
    ref = images[ref_index].contiguous()

    # ---- fine pass: residual shifts c_v * j over the pre-warped sources -------
    fine_shifts = c[:, None, :] * np.arange(df, dtype=np.float32)[None, :, None]  # (S, Df, 2)
    cfg_f = dataclasses.replace(cfg, num_planes=df, sources_8bit=False)
    vol, _, _ = plane_sweep_volume(
        torch.cat([ref[None], wsrc]), cameras, 0, tuple(range(1, n_src + 1)), cfg_f,
        shift_pad=fine_shift_pad if fine_shift_pad is not None else shift_pad,
        depths=depths_full[:df], backend=backend, shifts=fine_shifts)
    k_f, cost, conf, _ = _volume_to_maps(vol, ref, cfg_f, sgm_cfg, backend)

    # ---- decode to the full plane range ----------------------------------------
    k_full = k_f + offset
    inv_near = 1.0 / cfg.z_near
    step = (1.0 / cfg.z_far - inv_near) / max(total - 1, 1)
    depth = torch.reciprocal((k_full * step + inv_near).clamp_min(1e-9))
    # true per-view visibility at the winning plane, in the original frame
    a_t = host_to_device(a, dev)[..., None, None]
    c_t = host_to_device(c, dev)[..., None, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    pu = u + a_t[:, 0] + c_t[:, 0] * k_full[None]
    pv = v + a_t[:, 1] + c_t[:, 1] * k_full[None]
    ok = (pu >= 0.0) & (pu <= w - 1.0) & (pv >= 0.0) & (pv <= h - 1.0)
    views_at_win = ok.sum(dim=0, dtype=torch.int32)
    valid = views_at_win >= min_views
    if mask is not None:
        valid = valid & mask
    return PlaneSweepOutput(depth=torch.where(valid, depth, 0.0), plane=k_full, cost=cost,
                            valid=valid, num_views=views_at_win,
                            confidence=torch.where(valid, conf, 0.0))
