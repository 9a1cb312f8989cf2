"""Rectified two-view SGM disparity pipeline (twin of
``stereovisionarray_tpu/models/two_view.py``).

Integer costs (int16 at scale 4, int8 at scale 1) run the reference's
integer fast path: census/BT cost volume (K1) -> 4/8-path SGM (K2/K3) ->
WTA, subpixel, uniqueness and right-view maps (K4) -> left-right gather (K5)
-> PKRN confidence -> optional post-filters (median, speckle, hole fill;
``ops/postfilter.py``) -> guarded depth. float32 costs run the reference's
float Pallas route: float cost volume (K1) -> float SGM summed in the
reference's order (K7, ``order="k7"``) -> standalone extraction with the
in-volume LR check (K6) -> the same post-filters. On a CUDA tensor every
stage with a kernel launches it; on a CPU tensor (or ``backend="torch"``) the
plain PyTorch twins run, bit-exact to the reference's
``backend="pallas_interpret"`` path. ``backend="xla"`` runs the plain twin of
the reference's XLA oracle route (float scans and edge-clamped extraction;
integer cost dtypes compute in float32 there, as in the reference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereovisionarray_tpu_torch.config import CostConfig, SGMConfig
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.confidence import pkrn_confidence
from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
from stereovisionarray_tpu_torch.ops.cost_volume import (
    as_dtype,
    cost_scale_for,
    fused_cost_volume,
    int8_cost_fits,
    right_from_left_volume,
)
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    BIG_FLOAT,
    extract_disparity,
    extract_maps,
    lr_gather,
)
from stereovisionarray_tpu_torch.ops.postfilter import fill_holes, median3x3, speckle_filter
from stereovisionarray_tpu_torch.ops.sgm import p2_maps, sgm_aggregate, sum_dtype
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float, sgm_aggregate_paths
from stereovisionarray_tpu_torch.ops.wta import (
    INVALID_DISPARITY,
    DisparityResult,
    disparity_from_volume,
)


class TwoViewOutput(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, INVALID_DISPARITY where rejected
    valid: torch.Tensor  # (H, W) bool
    cost: torch.Tensor  # (H, W) winning aggregated cost
    depth: Optional[torch.Tensor] = None  # (H, W) when baseline+focal given
    confidence: Optional[torch.Tensor] = None  # (H, W) PKRN in [0,1), 0 invalid


class Penalties(NamedTuple):
    dtype: torch.dtype  # cost dtype after the int8 -> int16 widening rule
    scale: int  # fixed-point cost scale
    p1: float  # penalties in cost units (ints for integer dtypes)
    p2: float
    p2_min: float


def scaled_penalties(cost_cfg: CostConfig, sgm_cfg: SGMConfig, dtype) -> Penalties:
    """The cost dtype the pipeline really uses and the SGM penalties in its
    units. int8 widens to int16 when the census window's worst cost does not
    fit int8 at scale 1; integer dtypes take ``round(v * scale)`` (Python's
    round, half to even), as the reference's two-view pipeline does."""
    dt = as_dtype(dtype)
    if dt == torch.int8 and not int8_cost_fits(cost_cfg.census_window, cost_cfg.bt_weight,
                                               cost_cfg.bt_clip):
        dt = torch.int16
    if dt == torch.float32:
        return Penalties(dt, 1, sgm_cfg.p1, sgm_cfg.p2, sgm_cfg.p2_min)
    scale = cost_scale_for(dt)
    return Penalties(dt, scale, round(sgm_cfg.p1 * scale), round(sgm_cfg.p2 * scale),
                     round(sgm_cfg.p2_min * scale))


def _guarded_inverse(x: torch.Tensor, baseline: float, focal_px: float, eps: float,
                     invalid_fill: float) -> torch.Tensor:
    """B * f_px / x where x > eps, `invalid_fill` elsewhere (B * f_px rounded
    once to float32, as the reference's weakly typed scalar is)."""
    ok = x > eps
    bf = torch.tensor(baseline * focal_px, dtype=x.dtype, device=x.device)
    return torch.where(ok, bf / torch.where(ok, x, 1.0), invalid_fill)


def disparity_to_depth(disparity: torch.Tensor, baseline: float, focal_px: float,
                       invalid_fill: float = 0.0) -> torch.Tensor:
    """depth = B * f_px / d, `invalid_fill` where d <= 1e-6."""
    return _guarded_inverse(disparity, baseline, focal_px, 1e-6, invalid_fill)


def depth_to_disparity(depth: torch.Tensor, baseline: float, focal_px: float,
                       invalid_fill: float = 0.0) -> torch.Tensor:
    """Inverse of :func:`disparity_to_depth` (same guarded hyperbola)."""
    return _guarded_inverse(depth, baseline, focal_px, 1e-9, invalid_fill)


def _integer_path(left, right, cost_cfg, sgm_cfg, pen, mask, backend) -> DisparityResult:
    D = cost_cfg.num_disparities
    vol = fused_cost_volume_cuda(left, right, D, cost_cfg.census_window, cost_cfg.bt_weight,
                                 cost_cfg.bt_clip, pen.dtype, backend)
    p2_y, p2_x = p2_maps(left.shape, pen.p2, sum_dtype(pen.dtype), left.device, left,
                         sgm_cfg.adaptive_p2, pen.p2_min)
    total = sgm_aggregate_paths(vol, p2_y, p2_x, pen.p1, sgm_cfg.num_paths, backend)
    maps = extract_maps(total, sgm_cfg.subpixel, max(sgm_cfg.uniqueness, 0.0), backend)
    valid = maps.valid
    if sgm_cfg.lr_max_diff > 0:
        at = lr_gather(maps.disparity, maps.disparity_right, D, backend)
        valid = valid & ((maps.disparity - at).abs() <= sgm_cfg.lr_max_diff) & (at < BIG_FLOAT)
    if mask is not None:
        valid = valid & mask
    return DisparityResult(
        disparity=torch.where(valid, maps.disparity, INVALID_DISPARITY),
        cost=maps.cost,
        valid=valid,
        confidence=pkrn_confidence(maps.cost, maps.second, valid),
    )


def _float_path(left, right, cost_cfg, sgm_cfg, mask, backend) -> DisparityResult:
    """The reference's float Pallas route: K1 float -> K7 -> K6."""
    vol = fused_cost_volume_cuda(left, right, cost_cfg.num_disparities, cost_cfg.census_window,
                                 cost_cfg.bt_weight, cost_cfg.bt_clip, torch.float32, backend)
    p2_y, p2_x = p2_maps(left.shape, sgm_cfg.p2, torch.float32, left.device, left,
                         sgm_cfg.adaptive_p2, sgm_cfg.p2_min)
    total = sgm_aggregate_float(vol, p2_y, p2_x, sgm_cfg.p1, sgm_cfg.num_paths, order="k7",
                                backend=backend)
    return extract_disparity(total, sgm_cfg.subpixel, max(sgm_cfg.uniqueness, 0.0),
                             max(sgm_cfg.lr_max_diff, 0.0), mask, backend)


def _xla_path(left, right, cost_cfg, sgm_cfg, mask) -> DisparityResult:
    """The reference's XLA oracle route: float scans summed in path order,
    edge-clamped right view."""
    vol = fused_cost_volume(left, right, cost_cfg.num_disparities, cost_cfg.census_window,
                            cost_cfg.bt_weight, cost_cfg.bt_clip, torch.float32)
    agg = sgm_aggregate(vol, sgm_cfg.p1, sgm_cfg.p2, sgm_cfg.num_paths, left,
                        sgm_cfg.adaptive_p2, sgm_cfg.p2_min)
    vol_right = right_from_left_volume(agg) if sgm_cfg.lr_max_diff > 0 else None
    return disparity_from_volume(agg, vol_right, sgm_cfg.subpixel, sgm_cfg.uniqueness,
                                 sgm_cfg.lr_max_diff, mask, with_confidence=True)


def two_view_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    cost_cfg: CostConfig = CostConfig(),
    sgm_cfg: SGMConfig = SGMConfig(),
    mask: Optional[torch.Tensor] = None,
    baseline: Optional[float] = None,
    focal_px: Optional[float] = None,
    backend: str = "auto",
) -> TwoViewOutput:
    """Full rectified two-view pipeline on (H, W) grayscale images.

    backend: "auto" (kernels for CUDA tensors, plain PyTorch for CPU
    tensors), "cuda" (kernels, CUDA tensors only), "torch" (plain PyTorch
    on any device) or "xla" (the plain twin of the reference's XLA route)."""
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    pen = scaled_penalties(cost_cfg, sgm_cfg, cost_cfg.dtype)
    if resolve_backend(left, backend) == "xla":
        res = _xla_path(left, right, cost_cfg, sgm_cfg, mask)
    elif pen.dtype == torch.float32:
        res = _float_path(left, right, cost_cfg, sgm_cfg, mask, backend)
    else:
        res = _integer_path(left, right, cost_cfg, sgm_cfg, pen, mask, backend)

    disparity, valid = res.disparity, res.valid
    # post-filters, in the reference's order; they can invalidate pixels, and
    # the confidence below is zeroed there
    if sgm_cfg.median_filter:
        disparity = median3x3(disparity, valid)
    if sgm_cfg.speckle_window > 0:
        disparity, valid = speckle_filter(disparity, valid, max_diff=sgm_cfg.speckle_max_diff,
                                          window=sgm_cfg.speckle_window,
                                          min_support=sgm_cfg.speckle_min_support)
    if sgm_cfg.fill_holes:
        disparity, valid = fill_holes(disparity, valid)
    depth = None
    if baseline is not None and focal_px is not None:
        depth = torch.where(valid, disparity_to_depth(disparity, baseline, focal_px), 0.0)
    return TwoViewOutput(
        disparity=disparity, valid=valid, cost=res.cost, depth=depth,
        confidence=torch.where(valid, res.confidence, 0.0),
    )
