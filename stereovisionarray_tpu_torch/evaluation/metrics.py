"""Middlebury bad-τ ratio and end-point error (twin of
``stereovisionarray_tpu/evaluation/metrics.py``); float32 sums, mask-aware."""

from __future__ import annotations

from typing import Optional

import torch


def _masked(values: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return values, torch.ones_like(values, dtype=torch.float32)
    # broadcast the mask up-front: a (1, W) mask against (H, W) values must
    # count every row in the denominator
    m = torch.broadcast_to(mask, torch.broadcast_shapes(values.shape, mask.shape))
    m = m.to(torch.float32)
    return values * m, m


def bad_pixel_ratio(disparity: torch.Tensor, gt: torch.Tensor, tau: float = 2.0,
                    mask: Optional[torch.Tensor] = None,
                    invalid_counts_bad: bool = True) -> torch.Tensor:
    """Fraction of (masked) pixels with |d - d_gt| > τ; invalid predictions
    (d < 0) count as bad when `invalid_counts_bad`."""
    bad = (disparity - gt).abs() > tau
    if invalid_counts_bad:
        bad = bad | (disparity < 0)
    badf, m = _masked(bad.to(torch.float32), mask)
    return badf.sum() / m.sum().clamp_min(1.0)


def end_point_error(disparity: torch.Tensor, gt: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |d - d_gt| over valid predictions within the mask."""
    valid = disparity >= 0
    m = valid if mask is None else (valid & mask)
    err, mf = _masked((disparity - gt).abs(), m)
    return err.sum() / mf.sum().clamp_min(1.0)
