"""The cost volume on the card: kernel K1 (twin of
``stereovisionarray_tpu/ops/cost_pallas.py``).

One CUDA kernel (``csrc/cost_volume.cu``) replaces both TPU builders,
``fused_cost_volume_pallas_wdh`` and ``fused_cost_volume_pallas_hdw``; it
writes the (H, W, D) layout directly: int8 or int16 fixed-point costs, or
unscaled float32 costs (the reference's XLA float cost volume, which the
float route of the two-view pipeline reads). Its plain twin is
``ops/cost_volume.fused_cost_volume``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.cost_volume import (
    as_dtype,
    cost_scale_for,
    fused_cost_volume,
    int8_cost_fits,
    worst_cost,
)

MAX_CENSUS_BITS = 256  # the kernel packs a census code into at most 4 x 64 bits


def fused_cost_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    census_window: Tuple[int, int] = (7, 9),
    bt_weight: float = 0.25,
    bt_clip: float = 32.0,
    dtype="int16",
    backend: str = "auto",
) -> torch.Tensor:
    """(H, W, D) int8 / int16 / float32 census + BT cost volume from (H, W)
    images."""
    out_dtype = as_dtype(dtype)
    if resolve_backend(left, backend) != "cuda":
        return fused_cost_volume(left, right, num_disparities, census_window,
                                 bt_weight, bt_clip, out_dtype)
    if out_dtype == torch.int8 and not int8_cost_fits(census_window, bt_weight, bt_clip):
        raise ValueError(f"census window {census_window} + bt overflows int8; use int16")
    wh, ww = census_window
    if wh % 2 == 0 or ww % 2 == 0 or wh * ww - 1 > MAX_CENSUS_BITS:
        raise ValueError(f"census window must be odd with <= {MAX_CENSUS_BITS} bits, "
                         f"got {census_window}")
    h, w = left.shape
    _native.check(left, "left", torch.float32, (h, w))
    _native.check(right, "right", torch.float32, (h, w))
    if out_dtype == torch.float32:
        # the plain float cost volume's out-of-image cost, in its float32 arithmetic
        worst = np.float32(wh * ww - 1)
        if bt_weight > 0.0:
            worst = worst + np.float32(bt_weight) * np.float32(bt_clip)
    else:
        worst = worst_cost(census_window, bt_weight, bt_clip)
    out = torch.empty((h, w, num_disparities), dtype=out_dtype, device=left.device)
    _native.launch(
        "svt_cost_volume", left.device, left.data_ptr(), right.data_ptr(), out.data_ptr(),
        out.element_size(), h, w, num_disparities, wh, ww, float(bt_weight),
        float(bt_clip), float(worst), float(cost_scale_for(out_dtype)),
    )
    fused_cost_volume_cuda.launches += 1
    return out


fused_cost_volume_cuda.launches = 0
