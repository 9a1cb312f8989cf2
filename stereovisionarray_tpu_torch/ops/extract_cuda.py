"""Disparity extraction from an integer SGM total: kernels K4 and K5
(twin of ``stereovisionarray_tpu/ops/extract_pallas.py`` and of the extraction
half of ``sgm_pallas._rl_extract_kernel``).

:func:`extract_maps` (K4, ``csrc/extract.cu``) reads the aggregated (H, W, D)
total once per view and emits five (H, W) maps: the left subpixel disparity,
the winning cost, the uniqueness validity, the second-best cost outside
winner±1 (PKRN numerator) and the right-view subpixel disparity.
:func:`lr_gather` (K5) gathers ``d_R(x - round(d_L))`` for the left-right
check. Each has its plain PyTorch twin here, bit-exact to the reference:

 - WTA ties go to the smallest d (the reference's packed ``cost << lg | d`` min);
 - the parabola runs in float32 and applies only where 1 <= d <= D-2,
   clipped to ±0.5;
 - right-view candidates with x + d >= W and LR sources with x - d < 0 read
   BIG instead of an edge-clamped value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.sgm import BIG_INT

BIG_FLOAT = 1e9  # out-of-image LR source (float maps)


class ExtractMaps(NamedTuple):
    disparity: torch.Tensor  # (H, W) f32 left subpixel disparity (pre-masking)
    cost: torch.Tensor  # (H, W) f32 winning aggregated cost
    valid: torch.Tensor  # (H, W) bool uniqueness validity
    second: torch.Tensor  # (H, W) f32 best cost outside winner±1
    disparity_right: torch.Tensor  # (H, W) f32 right-view subpixel disparity


def _wta(a: torch.Tensor):
    """(..., D) int32 -> min cost, winner (ties: smallest d), and the costs at
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


def extract_maps_plain(total: torch.Tensor, subpixel: bool = True,
                       uniqueness: float = 0.0) -> ExtractMaps:
    """Plain PyTorch twin of K4 over an (H, W, D) integer total."""
    h, w, D = total.shape
    a = total.to(torch.int32)
    disp, c_min, d_int = _disparity(a, subpixel)
    d_iota = torch.arange(D, device=a.device)
    near = (d_iota - d_int[..., None]).abs() <= 1
    second = torch.where(near, BIG_INT, a).amin(dim=-1).to(torch.float32)
    cost = c_min.to(torch.float32)
    valid = torch.ones((h, w), dtype=torch.bool, device=a.device)
    if uniqueness > 0.0:
        valid &= cost < uniqueness * second
    # right view: ar[y, x, d] = total[y, x + d, d], BIG past the right border
    src = torch.arange(w, device=a.device)[:, None] + d_iota[None, :]
    ar = torch.gather(a, 1, src.clamp(max=w - 1).expand(h, w, D))
    ar = torch.where(src < w, ar, BIG_INT)
    disp_r, _, _ = _disparity(ar, subpixel)
    return ExtractMaps(disp, cost, valid, second, disp_r)


def extract_maps(total: torch.Tensor, subpixel: bool = True, uniqueness: float = 0.0,
                 backend: str = "auto") -> ExtractMaps:
    """K4: the five extraction maps of an (H, W, D) int16 SGM total."""
    if total.dim() != 3 or total.shape[-1] < 3:
        raise ValueError(f"total must be (H, W, D) with D >= 3, got {tuple(total.shape)}")
    if resolve_backend(total, backend) == "torch":
        return extract_maps_plain(total, subpixel, uniqueness)
    h, w, D = total.shape
    _native.check(total, "total", torch.int16, (h, w, D))
    f32 = dict(dtype=torch.float32, device=total.device)
    disp, cost, second, disp_r = (torch.empty((h, w), **f32) for _ in range(4))
    valid = torch.empty((h, w), dtype=torch.bool, device=total.device)
    _native.launch(
        "svt_extract_maps", total.device, total.data_ptr(), h, w, D, int(bool(subpixel)),
        float(uniqueness) if uniqueness > 0.0 else 0.0, disp.data_ptr(),
        cost.data_ptr(), valid.data_ptr(), second.data_ptr(), disp_r.data_ptr(),
    )
    extract_maps.launches += 1
    return ExtractMaps(disp, cost, valid, second, disp_r)


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
    """K5: the right-view disparity at each left pixel's match, (H, W) f32."""
    if resolve_backend(disp_l, backend) == "torch":
        return lr_gather_plain(disp_l, disp_r, n_disp)
    h, w = disp_l.shape
    _native.check(disp_l, "disp_l", torch.float32, (h, w))
    _native.check(disp_r, "disp_r", torch.float32, (h, w))
    at = torch.empty((h, w), dtype=torch.float32, device=disp_l.device)
    _native.launch("svt_lr_gather", disp_l.device, disp_l.data_ptr(), disp_r.data_ptr(),
                   at.data_ptr(), h, w, int(n_disp))
    lr_gather.launches += 1
    return at


lr_gather.launches = 0
