"""Temporal stereo: a confidence-weighted recursive filter of a disparity
stream from a fixed rig (twin of ``stereovisionarray_tpu/models/temporal.py``).

Per pixel:
  - AGREE (|d_t - d_state| <= max_diff): blend, accumulating evidence weight;
  - MOVE (valid but inconsistent): reset to the new measurement, so moving
    content does not ghost;
  - HOLE (no measurement): hold the last value while its weight halves, for
    at most ``max_hole_age`` frames, then drop it.

Elementwise tensor code on the measurement's device: :func:`temporal_update`
is one step (state in, state out); :func:`temporal_filter_sequence` runs a
(T, H, W) stack through it in order. Weights ride the PKRN confidence maps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stereovisionarray_tpu_torch.ops.sgm import fmaf
from stereovisionarray_tpu_torch.ops.wta import INVALID_DISPARITY

__all__ = ["TemporalOutput", "TemporalState", "temporal_filter_sequence", "temporal_init",
           "temporal_update"]


class TemporalState(NamedTuple):
    """Per-pixel recursive filter state (all (H, W))."""

    disparity: torch.Tensor  # filtered disparity (INVALID where empty)
    weight: torch.Tensor  # accumulated evidence weight (0 where empty)
    age: torch.Tensor  # int32 frames since last direct measurement


class TemporalOutput(NamedTuple):
    disparity: torch.Tensor  # (H, W) filtered disparity
    valid: torch.Tensor  # (H, W) bool
    stability: torch.Tensor  # (H, W) evidence weight / max_weight in [0, 1]
    coasted: Optional[torch.Tensor] = None  # (H, W) bool: held, not measured this frame


def temporal_init(shape: Tuple[int, int], device=None) -> TemporalState:
    """Empty state for an (H, W) stream on `device`."""
    return TemporalState(
        disparity=torch.full(shape, INVALID_DISPARITY, dtype=torch.float32, device=device),
        weight=torch.zeros(shape, dtype=torch.float32, device=device),
        age=torch.zeros(shape, dtype=torch.int32, device=device))


def temporal_update(state: TemporalState, disparity: torch.Tensor, valid: torch.Tensor,
                    confidence: Optional[torch.Tensor] = None, *, max_diff: float = 1.0,
                    max_weight: float = 8.0, max_hole_age: int = 3,
                    coast_min_weight: float = 1.0) -> Tuple[TemporalState, TemporalOutput]:
    """One recursive-filter step: (new_state, output).

    confidence: optional (H, W) evidence weight in [0, 1] (PKRN), default 1.
    max_diff: consistency gate in px; a valid measurement farther than this
    from the state resets the pixel. max_weight: evidence saturation (the
    filter's time constant). max_hole_age: most frames an unmeasured pixel
    coasts. coast_min_weight: the weight halves each coasted frame, so a
    pixel coasts min(max_hole_age, log2(w / coast_min_weight)) frames."""
    disparity = disparity.to(torch.float32)
    c = torch.ones_like(disparity) if confidence is None else confidence.to(torch.float32)
    c = torch.where(valid, torch.clamp(c, min=1e-3), 0.0)

    has_state = state.weight > 0.0
    agree = valid & has_state & ((disparity - state.disparity).abs() <= max_diff)
    reset = valid & ~agree  # fresh pixel or moving content
    hole = (~valid & has_state & (state.age < max_hole_age)
            & (state.weight >= 2.0 * coast_min_weight))

    w_prev = state.weight
    # AGREE: running weighted mean with saturating weight
    w_blend = w_prev + c
    # XLA contracts w_prev * d_state + c * d into one fused multiply-add on
    # the CPU; the blend rounds as it does there
    d_blend = fmaf(w_prev, state.disparity, c * disparity) / torch.clamp(w_blend, min=1e-9)
    new_d = torch.where(agree, d_blend, torch.where(reset, disparity, state.disparity))
    new_w = torch.where(agree, torch.clamp(w_blend, max=max_weight),
                        torch.where(reset, c, torch.where(hole, w_prev * 0.5, 0.0)))
    new_age = torch.where(valid, 0, torch.where(hole, state.age + 1, 0)).to(torch.int32)
    out_valid = valid | hole
    new_d = torch.where(new_w > 0.0, new_d, INVALID_DISPARITY)

    new_state = TemporalState(disparity=new_d, weight=new_w, age=new_age)
    out = TemporalOutput(disparity=torch.where(out_valid, new_d, INVALID_DISPARITY),
                         valid=out_valid, stability=torch.clamp(new_w / max_weight, 0.0, 1.0),
                         coasted=hole)
    return new_state, out


def temporal_filter_sequence(disparities: torch.Tensor, valids: torch.Tensor,
                             confidences: Optional[torch.Tensor] = None, *,
                             max_diff: float = 1.0, max_weight: float = 8.0,
                             max_hole_age: int = 3,
                             coast_min_weight: float = 1.0) -> TemporalOutput:
    """Filter a whole (T, H, W) sequence from an empty state; stacked
    (T, H, W) outputs."""
    t, h, w = disparities.shape
    state = temporal_init((h, w), disparities.device)
    outs = []
    for k in range(t):
        state, out = temporal_update(
            state, disparities[k], valids[k], None if confidences is None else confidences[k],
            max_diff=max_diff, max_weight=max_weight, max_hole_age=max_hole_age,
            coast_min_weight=coast_min_weight)
        outs.append(out)
    return TemporalOutput(*(torch.stack(f) for f in zip(*outs)))
