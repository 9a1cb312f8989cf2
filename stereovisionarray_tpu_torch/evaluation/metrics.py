"""Middlebury bad-τ ratio, end-point error and the trajectory error of a
calibration (twin of ``stereovisionarray_tpu/evaluation/metrics.py``);
float32 sums, mask-aware."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _masked(values: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return values, torch.ones_like(values, dtype=torch.float32)
    # broadcast the mask up-front: a (1, W) mask against (H, W) values must
    # count every row in the denominator
    m = torch.broadcast_to(mask, torch.broadcast_shapes(values.shape, mask.shape))
    m = m.to(torch.float32)
    return values * m, m


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


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


def array_depth_metrics(depth, refined_depth, valid, gt, border: int = 8) -> dict:
    """Camera-array accuracy as ``scripts/make_array_eval.py`` scores it, over
    the valid pixels of the interior (a `border`-pixel band dropped): median
    relative depth error of the sweep and of the refined depth, the fraction
    of refined pixels within 1%, and the valid share of the interior.
    Inputs are (H, W) tensors or arrays; computed in numpy on the host."""
    depth, refined_depth, valid, gt = map(_host, (depth, refined_depth, valid, gt))
    inner = np.zeros(valid.shape, dtype=bool)
    inner[border:-border, border:-border] = True
    sel = valid & inner
    rel = lambda d: np.abs((np.abs(d) - gt)[sel] / gt[sel])  # noqa: E731
    r_sweep, r_ref = rel(depth), rel(refined_depth)
    return {
        "median_rel_depth_err_sweep": float(np.median(r_sweep)),
        "median_rel_depth_err_refined": float(np.median(r_ref)),
        "frac_rel_err_lt_1pct_refined": float((r_ref < 0.01).mean()),
        "density": float(sel.sum() / inner.sum()),
    }


def cascade_disparity_metrics(disparity, gt, mask) -> dict:
    """Two-view accuracy as ``scripts/perf_cascade.py`` scores the cascade,
    over the mask's pixels with a valid (>= 0) disparity: the valid share of
    the mask, the fraction off by more than 2 px, the mean and the median
    absolute error. Computed in numpy on the host."""
    d, gt, mask = map(_host, (disparity, gt, mask))
    m = mask & (d >= 0)
    err = np.abs(d - gt)[m]
    return {"valid_in_mask": float(m.sum() / mask.sum()), "bad2": float((err > 2.0).mean()),
            "epe": float(err.mean()), "median_err": float(np.median(err))}


def cascade_depth_metrics(depth, valid, gt, border: int = 8) -> dict:
    """Camera-array accuracy as ``scripts/perf_cascade_sweep.py`` scores it,
    over the valid pixels of the interior: the valid share of the interior
    and the median and mean relative depth error, and the fraction above 2%.
    Computed in numpy on the host."""
    depth, valid, gt = map(_host, (depth, valid, gt))
    inner = np.zeros(valid.shape, dtype=bool)
    inner[border:-border, border:-border] = True
    sel = valid & inner
    rel = np.abs(depth[sel] - gt[sel]) / gt[sel]
    return {"valid_inner": float(sel.sum() / inner.sum()), "median_rel": float(np.median(rel)),
            "mean_rel": float(rel.mean()), "bad2pct": float((rel > 0.02).mean())}


def absolute_trajectory_error(centers_est: torch.Tensor, centers_gt: torch.Tensor,
                              align: bool = True, align_scale: bool = False) -> torch.Tensor:
    """RMSE of camera centres (N, 3) after an optional Umeyama alignment:
    rotation and translation, and with `align_scale` the global scale too
    (monocular BA cannot observe scale)."""
    if not align:
        aligned = centers_est
    else:
        mu_e, mu_g = centers_est.mean(dim=0), centers_gt.mean(dim=0)
        e, g = centers_est - mu_e, centers_gt - mu_g
        cov = torch.sum(e[:, :, None] * g[:, None, :], dim=0)  # e^T g, elementwise (no TF32)
        u, s, vt = torch.linalg.svd(cov)
        vu = torch.sum(vt.T[:, :, None] * u.T[None, :, :], dim=1)
        sign = torch.sign(torch.linalg.det(vu))
        D = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign])
        R = torch.sum((vt.T * D)[:, :, None] * u.T[None, :, :], dim=1)  # V D U^T
        scale = 1.0
        if align_scale:
            scale = torch.sum(s * D) / torch.clamp(torch.sum(e * e), min=1e-12)
        aligned = scale * torch.sum(R[None] * e[:, None, :], dim=-1) + mu_g
    return torch.sqrt(torch.mean(torch.sum((aligned - centers_gt) ** 2, dim=-1)))
