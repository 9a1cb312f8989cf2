"""Disparity extraction from an SGM total or a raw volume: kernels K4, K5 and
K6 (twin of ``stereovisionarray_tpu/ops/extract_pallas.py`` and of the
extraction half of ``sgm_pallas._rl_extract_kernel``).

:func:`extract_maps` (K4, ``csrc/extract.cu``) reads the aggregated (H, W, D)
total once per view and emits five (H, W) maps: the left subpixel disparity,
the winning cost, the validity, the second-best cost outside winner±1 (PKRN
numerator) and the right-view subpixel disparity. With ``lr_max_diff > 0``
the validity also carries the left-right check, K5's gather
``at = d_R(x - round(d_L))`` and the reference's test
``|d_L - at| <= lr_max_diff & at < BIG`` (``sgm_pallas.py:1093-1095``), in the
same launch: the right map then reaches HBM only when ``right=True``.
:func:`lr_gather` (K5 on its own, twin of ``lr_gather_maps``) returns ``at``.
:func:`extract_disparity_maps` (K6, twin of ``extract_maps_hdw``) runs the
same kernel over an int8, int16 or float32 volume with the same fused check;
:func:`extract_disparity` (twin of ``extract_disparity_hdw``) adds the mask,
``INVALID_DISPARITY`` and PKRN. Each has its plain PyTorch twin here,
bit-exact to the reference:

 - WTA ties go to the smallest d (the reference's packed ``cost << lg | d``
   min on integers, its masked argmin on floats);
 - int8 volumes widen before anything; integer volumes use BIG = 16000,
   float32 volumes BIG = 1e9;
 - the parabola runs in float32 and applies only where 1 <= d <= D-2,
   clipped to ±0.5;
 - right-view candidates with x + d >= W and LR sources with x - d < 0 read
   BIG instead of an edge-clamped value.

Launch counts: ``extract_maps.launches`` (K4) and
``extract_disparity_maps.launches`` (K6) count their extraction launches;
``lr_gather.launches`` counts the standalone gather and
``lr_gather.fused_launches`` the K4 and K6 launches that ran the LR check.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.confidence import pkrn_confidence
from stereovisionarray_tpu_torch.ops.sgm import BIG_INT
from stereovisionarray_tpu_torch.ops.wta import INVALID_DISPARITY, DisparityResult

BIG_FLOAT = 1e9  # out-of-image LR source (float maps) and float-volume sentinel
VOLUME_DTYPES = (torch.int8, torch.int16, torch.float32)
# the kernel's LR check keeps a row's right view in the shared memory of a
# cluster of at most 8 CTAs, 48 KB each
MAX_LR_WIDTH = 8 * 12288


class ExtractMaps(NamedTuple):
    disparity: torch.Tensor  # (H, W) f32 left subpixel disparity (pre-masking)
    cost: torch.Tensor  # (H, W) f32 winning aggregated cost
    valid: torch.Tensor  # (H, W) bool uniqueness (and LR, when asked) validity
    second: torch.Tensor  # (H, W) f32 best cost outside winner±1
    disparity_right: Optional[torch.Tensor]  # (H, W) f32 right-view subpixel disparity


class DisparityMaps(NamedTuple):
    """The reference's ``extract_pallas.ExtractMaps``."""

    disparity: torch.Tensor  # (H, W) f32 left subpixel disparity (pre-masking)
    cost: torch.Tensor  # (H, W) f32 winning cost
    valid: torch.Tensor  # (H, W) bool uniqueness & LR validity
    second: torch.Tensor  # (H, W) f32 best cost outside winner±1 (PKRN)


def _wta(a: torch.Tensor):
    """(..., D) int32 or float32 -> min cost, winner (ties: smallest d), and the costs at
    clamp(winner, 1, D-2) -/+ 1."""
    D = a.shape[-1]
    c_min, d_int = torch.min(a, dim=-1)
    d_c = d_int.clamp(1, D - 2)
    cm = torch.gather(a, -1, (d_c - 1)[..., None])[..., 0]
    cp = torch.gather(a, -1, (d_c + 1)[..., None])[..., 0]
    return c_min, d_int, d_c, cm, cp


def _subpixel(d_int, d_c, cm, c0, cp, D: int) -> torch.Tensor:
    """Parabola in float32, as ``extract_pallas._subpixel``."""
    cm, c0, cp = cm.to(torch.float32), c0.to(torch.float32), cp.to(torch.float32)
    denom = cm - 2.0 * c0 + cp
    nonflat = denom.abs() > 1e-9
    safe = torch.where(nonflat, denom, 1.0)
    delta = torch.where(nonflat, (cm - cp) / (2.0 * safe), 0.0).clamp(-0.5, 0.5)
    interior = (d_int >= 1) & (d_int <= D - 2)
    return torch.where(interior, d_c.to(torch.float32) + delta, d_int.to(torch.float32))


def _disparity(a: torch.Tensor, subpixel: bool):
    c_min, d_int, d_c, cm, cp = _wta(a)
    D = a.shape[-1]
    disp = _subpixel(d_int, d_c, cm, c_min, cp, D) if subpixel else d_int.to(torch.float32)
    return disp, c_min, d_int


def extract_maps_plain(total: torch.Tensor, subpixel: bool = True, uniqueness: float = 0.0,
                       lr_max_diff: float = 0.0, right: bool = True) -> ExtractMaps:
    """Plain PyTorch twin of K4 over an (H, W, D) int8, int16 or float32
    total (integers compute in int32): the maps, then the LR check when
    ``lr_max_diff > 0``; ``disparity_right`` is None unless ``right``."""
    h, w, D = total.shape
    integer = not total.dtype.is_floating_point
    a = total.to(torch.int32) if integer else total
    big = BIG_INT if integer else BIG_FLOAT
    disp, c_min, d_int = _disparity(a, subpixel)
    d_iota = torch.arange(D, device=a.device)
    near = (d_iota - d_int[..., None]).abs() <= 1
    second = torch.where(near, big, a).amin(dim=-1).to(torch.float32)
    cost = c_min.to(torch.float32)
    valid = torch.ones((h, w), dtype=torch.bool, device=a.device)
    if uniqueness > 0.0:
        valid &= cost < uniqueness * second
    # right view: ar[y, x, d] = total[y, x + d, d], BIG past the right border
    src = torch.arange(w, device=a.device)[:, None] + d_iota[None, :]
    ar = torch.gather(a, 1, src.clamp(max=w - 1).expand(h, w, D))
    ar = torch.where(src < w, ar, big)
    disp_r, _, _ = _disparity(ar, subpixel)
    if lr_max_diff > 0:
        valid = lr_check_plain(disp, disp_r, valid, D, lr_max_diff)
    return ExtractMaps(disp, cost, valid, second, disp_r if right else None)


def lr_check_plain(disp_l: torch.Tensor, disp_r: torch.Tensor, valid: torch.Tensor, n_disp: int,
                   lr_max_diff: float) -> torch.Tensor:
    """The reference's LR test on K5's gather (``sgm_pallas.py:1093-1095``):
    ``valid & |d_L - at| <= lr_max_diff & at < BIG``."""
    at = lr_gather_plain(disp_l, disp_r, n_disp)
    return valid & ((disp_l - at).abs() <= lr_max_diff) & (at < BIG_FLOAT)


def _check_volume(total: torch.Tensor) -> None:
    if total.dim() != 3 or total.shape[-1] < 3:
        raise ValueError(f"total must be (H, W, D) with D >= 3, got {tuple(total.shape)}")
    if total.dtype not in VOLUME_DTYPES:
        raise TypeError(f"extraction takes int8, int16 or float32 volumes, got {total.dtype}")


def _check_lr_width(w: int) -> None:
    if w > MAX_LR_WIDTH:
        raise ValueError(f"the kernel's LR check takes rows of at most {MAX_LR_WIDTH} "
                         f"columns, got {w}")


def _launch_maps(total: torch.Tensor, subpixel: bool, uniqueness: float, lr_max_diff: float,
                 right: bool) -> ExtractMaps:
    """One launch of the extraction kernel on an int8/int16/float32 volume,
    the LR check in it when ``lr_max_diff > 0``. Without `right` the right
    map stays out of HBM (``disparity_right`` None), and without the LR check
    the right view is skipped."""
    h, w, D = total.shape
    _native.check(total, "total", total.dtype, (h, w, D))
    lr = lr_max_diff > 0
    if lr:
        _check_lr_width(w)
    f32 = dict(dtype=torch.float32, device=total.device)
    disp, cost, second = (torch.empty((h, w), **f32) for _ in range(3))
    disp_r = torch.empty((h, w), **f32) if right else None
    valid = torch.empty((h, w), dtype=torch.bool, device=total.device)
    _native.launch(
        "svt_extract_maps", total.device, total.data_ptr(), total.element_size(), h, w, D,
        int(bool(subpixel)), float(uniqueness) if uniqueness > 0.0 else 0.0,
        float(lr_max_diff) if lr else 0.0, disp.data_ptr(), cost.data_ptr(), valid.data_ptr(),
        second.data_ptr(), disp_r.data_ptr() if right else None,
    )
    return ExtractMaps(disp, cost, valid, second, disp_r)


def extract_maps(total: torch.Tensor, subpixel: bool = True, uniqueness: float = 0.0,
                 backend: str = "auto", *, lr_max_diff: float = 0.0,
                 right: bool = True) -> ExtractMaps:
    """K4: the extraction maps of an (H, W, D) SGM total (int16 on the
    integer paths; int8 and float32 volumes are taken too), with the
    left-right check in the validity when ``lr_max_diff > 0``, in one launch.
    ``right=False`` leaves ``disparity_right`` out (None)."""
    _check_volume(total)
    if resolve_backend(total, backend) != "cuda":
        return extract_maps_plain(total, subpixel, uniqueness, lr_max_diff, right)
    maps = _launch_maps(total, subpixel, uniqueness, lr_max_diff, right)
    extract_maps.launches += 1
    if lr_max_diff > 0:
        lr_gather.fused_launches += 1
    return maps


extract_maps.launches = 0


def lr_gather_plain(disp_l: torch.Tensor, disp_r: torch.Tensor, n_disp: int) -> torch.Tensor:
    """Plain PyTorch twin of K5: ``at = d_R(x - clip(round(d_L), 0, D-1))``,
    BIG where the source column falls left of the image."""
    w = disp_l.shape[1]
    dl_int = torch.round(disp_l).to(torch.int64).clamp(0, n_disp - 1)
    src = torch.arange(w, device=disp_l.device)[None, :] - dl_int
    at = torch.gather(disp_r, 1, src.clamp(min=0))
    return torch.where(src >= 0, at, BIG_FLOAT)


def lr_gather(disp_l: torch.Tensor, disp_r: torch.Tensor, n_disp: int,
              backend: str = "auto") -> torch.Tensor:
    """K5 on its own: the right-view disparity at each left pixel's match,
    (H, W) f32 (the pipelines run it fused into K4 / K6)."""
    if resolve_backend(disp_l, backend) != "cuda":
        return lr_gather_plain(disp_l, disp_r, n_disp)
    shape = disp_l.shape
    _native.check(disp_l, "disp_l", torch.float32, shape)
    _native.check(disp_r, "disp_r", torch.float32, shape)
    if len(shape) != 2:
        raise ValueError(f"disp_l must be (H, W), got {tuple(shape)}")
    at = torch.empty_like(disp_l)
    _native.launch("svt_lr_gather", disp_l.device, disp_l.data_ptr(), disp_r.data_ptr(),
                   at.data_ptr(), shape[0], shape[1], int(n_disp))
    lr_gather.launches += 1
    return at


lr_gather.launches = 0
lr_gather.fused_launches = 0


def extract_disparity_maps(vol: torch.Tensor, subpixel: bool = True, uniqueness: float = 0.0,
                           lr_max_diff: float = 0.0, backend: str = "auto") -> DisparityMaps:
    """K6, twin of the reference's ``extract_maps_hdw``: WTA, subpixel,
    uniqueness and, when ``lr_max_diff > 0``, the left-right check
    ``|d - at| <= lr_max_diff & at < BIG`` with at the right-view disparity
    at each pixel's match, over an (H, W, D) int8, int16 or float32 volume
    (raw costs or an SGM total). One launch, the check in it."""
    _check_volume(vol)
    if resolve_backend(vol, backend) != "cuda":
        maps = extract_maps_plain(vol, subpixel, uniqueness, lr_max_diff, right=False)
        return DisparityMaps(maps.disparity, maps.cost, maps.valid, maps.second)
    out = launch_disparity_maps(vol, subpixel, uniqueness, lr_max_diff)
    extract_disparity_maps.launches += 1
    if lr_max_diff > 0:
        lr_gather.fused_launches += 1
    return out


extract_disparity_maps.launches = 0


def launch_disparity_maps(vol: torch.Tensor, subpixel: bool, uniqueness: float,
                          lr_max_diff: float) -> DisparityMaps:
    """K6's launch on a CUDA volume, counted by the caller: the maps, the LR
    check in the same kernel (the right view only for it)."""
    _check_volume(vol)
    maps = _launch_maps(vol, subpixel, uniqueness, lr_max_diff, right=False)
    return DisparityMaps(maps.disparity, maps.cost, maps.valid, maps.second)


def extract_disparity(vol: torch.Tensor, subpixel: bool = True, uniqueness: float = 0.0,
                      lr_max_diff: float = 0.0, mask: Optional[torch.Tensor] = None,
                      backend: str = "auto") -> DisparityResult:
    """Twin of the reference's ``extract_disparity_hdw``: the K6 maps, then the
    mask, ``INVALID_DISPARITY`` where rejected and PKRN confidence."""
    maps = extract_disparity_maps(vol, subpixel, uniqueness, lr_max_diff, backend)
    valid = maps.valid if mask is None else maps.valid & mask
    return DisparityResult(
        disparity=torch.where(valid, maps.disparity, INVALID_DISPARITY),
        cost=maps.cost,
        valid=valid,
        confidence=pkrn_confidence(maps.cost, maps.second, valid),
    )
