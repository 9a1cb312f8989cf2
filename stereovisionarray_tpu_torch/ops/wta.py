"""Winner-take-all extraction on float volumes, plain PyTorch (twin of
``stereovisionarray_tpu/ops/wta.py``): WTA, parabola subpixel, uniqueness
ratio test and the edge-clamped left-right check of the reference's XLA path.
The integer path extracts with the kernels of ``ops/extract_cuda.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INVALID_DISPARITY = -1.0


class DisparityResult(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, INVALID_DISPARITY where rejected
    cost: torch.Tensor  # (H, W) winning aggregated cost
    valid: torch.Tensor  # (H, W) bool
    confidence: Optional[torch.Tensor] = None  # (H, W) PKRN in [0,1), 0 invalid


def value_at(vol: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """vol (..., D) at integer index d (...) -> (...)."""
    return torch.gather(vol, -1, d.to(torch.int64)[..., None])[..., 0]


def winner_take_all(vol: torch.Tensor):
    """(H, W, D) -> (argmin disparity (H, W) int32, its cost); ties go to the
    smallest d."""
    c, d = torch.min(vol, dim=-1)
    return d.to(torch.int32), c


def subpixel_refine(vol: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Parabola through the (d-1, d, d+1) costs, delta clamped to [-0.5, 0.5];
    border disparities keep their integer value."""
    D = vol.shape[-1]
    d0 = disp.clamp(1, D - 2)
    cm, c0, cp = value_at(vol, d0 - 1), value_at(vol, d0), value_at(vol, d0 + 1)
    denom = cm - 2.0 * c0 + cp
    delta = torch.where(denom.abs() > 1e-9, (cm - cp) / (2.0 * denom), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    interior = (disp >= 1) & (disp <= D - 2)
    return torch.where(interior, d0.to(vol.dtype) + delta, disp.to(vol.dtype))


def uniqueness_mask(vol: torch.Tensor, disp: torch.Tensor, ratio: float) -> torch.Tensor:
    """best < ratio * second-best, the second best taken outside winner±1."""
    d_idx = torch.arange(vol.shape[-1], device=vol.device)
    near = (d_idx - disp[..., None]).abs() <= 1
    second = torch.where(near, torch.inf, vol).amin(dim=-1)
    return value_at(vol, disp) < ratio * second


def left_right_check(disp_left: torch.Tensor, disp_right: torch.Tensor,
                     max_diff: float = 1.25) -> torch.Tensor:
    """|d_L(x) - d_R(x - d_L(x))| <= max_diff, the source column rounded and
    edge-clamped."""
    w = disp_left.shape[1]
    x = torch.arange(w, device=disp_left.device)[None, :]
    xr = torch.round(x - disp_left).to(torch.int64).clamp(0, w - 1)
    d_r = torch.gather(disp_right, 1, xr)
    ok = (disp_left - d_r).abs() <= max_diff
    return ok & (disp_left >= 0) & (d_r >= 0)


def disparity_from_volume(
    vol: torch.Tensor,
    vol_right: Optional[torch.Tensor] = None,
    subpixel: bool = True,
    uniqueness: float = 0.0,
    lr_max_diff: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    with_confidence: bool = False,
) -> DisparityResult:
    """WTA -> subpixel -> uniqueness -> LR check -> ROI mask over a float
    (H, W, D) aggregated volume. `vol_right` (``right_from_left_volume``) is
    required when lr_max_diff > 0."""
    d_int, c = winner_take_all(vol)
    disp = subpixel_refine(vol, d_int) if subpixel else d_int.to(vol.dtype)
    valid = torch.ones(disp.shape, dtype=torch.bool, device=vol.device)
    if uniqueness > 0.0:
        valid &= uniqueness_mask(vol, d_int, uniqueness)
    if lr_max_diff > 0.0:
        if vol_right is None:
            raise ValueError("lr_max_diff > 0 requires vol_right")
        d_r_int, _ = winner_take_all(vol_right)
        d_r = subpixel_refine(vol_right, d_r_int) if subpixel else d_r_int.to(vol.dtype)
        valid &= left_right_check(disp, d_r, lr_max_diff)
    if mask is not None:
        valid &= mask
    disp = torch.where(valid, disp, INVALID_DISPARITY)
    conf = None
    if with_confidence:
        from stereovisionarray_tpu_torch.ops.confidence import confidence_from_volume

        conf = confidence_from_volume(vol, d_int, valid)
    return DisparityResult(disparity=disp, cost=c, valid=valid, confidence=conf)
