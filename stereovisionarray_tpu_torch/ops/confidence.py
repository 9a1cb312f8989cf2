"""PKRN stereo confidence (twin of ``stereovisionarray_tpu/ops/confidence.py``):
``1 - (c1 + eps) / (c2 + eps)`` with c1 the winning aggregated cost and c2
the best cost outside the winner's ±1 neighbourhood."""

from __future__ import annotations

from typing import Optional

import torch


def pkrn_confidence(best: torch.Tensor, second: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    eps: float = 1e-3) -> torch.Tensor:
    """Peak-ratio confidence in [0, 1); 0 where `valid` is False."""
    c1 = best.to(torch.float32).clamp_min(0.0)
    c2 = torch.maximum(second.to(torch.float32), c1)
    conf = 1.0 - (c1 + eps) / (c2 + eps)
    if valid is not None:
        conf = torch.where(valid, conf, 0.0)
    return conf


def second_best_cost(vol: torch.Tensor, d_int: torch.Tensor) -> torch.Tensor:
    """Best cost outside the winner's ±1 neighbourhood over the last axis."""
    d_iota = torch.arange(vol.shape[-1], device=vol.device)
    near = (d_iota - d_int[..., None]).abs() <= 1
    big = torch.iinfo(vol.dtype).max if not vol.dtype.is_floating_point else torch.inf
    return torch.where(near, big, vol).amin(dim=-1)


def confidence_from_volume(vol: torch.Tensor, d_int: torch.Tensor,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PKRN straight from an (..., D) aggregated volume and its WTA winner."""
    from stereovisionarray_tpu_torch.ops.wta import value_at

    return pkrn_confidence(value_at(vol, d_int), second_best_cost(vol, d_int), valid)
