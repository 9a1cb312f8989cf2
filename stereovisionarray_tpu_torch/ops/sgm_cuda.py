"""Integer SGM path scans: kernel K2/K3 (twin of the sweep kernels of
``stereovisionarray_tpu/ops/sgm_pallas.py``: ``_sweep_kernel_hdw_stacked``,
``_sweep_kernel_hdw`` and the sweep half of ``_rl_extract_kernel``).

One CUDA kernel (``csrc/sgm_paths.cu``) runs every path of the 4- or 8-path
set: one warp per line, D across the lanes. Its plain twin is
``ops/sgm.aggregate_paths``.
"""

from __future__ import annotations

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.sgm import aggregate_paths, sum_dtype

MAX_DISPARITIES = 256  # 8 values a lane


def sgm_aggregate_paths(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor,
                        p1: int, num_paths: int = 8, backend: str = "auto") -> torch.Tensor:
    """(H, W, D) int8/int16 costs -> (H, W, D) int16 sum over the SGM paths.
    p2_y/p2_x: (H, W) int16 penalty maps; p1 in cost units."""
    if resolve_backend(vol, backend) == "torch":
        return aggregate_paths(vol, p2_y, p2_x, p1, num_paths)
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    if vol.dtype not in (torch.int8, torch.int16):
        raise NotImplementedError(
            "the CUDA path scans take integer costs; float volumes need the "
            "aggregation kernel K7 (ROADMAP.md queue 1 item 4a)")
    h, w, D = vol.shape
    if not 3 <= D <= MAX_DISPARITIES:
        raise ValueError(f"num_disparities must be in [3, {MAX_DISPARITIES}], got {D}")
    _native.check(vol, "vol", vol.dtype, (h, w, D))
    _native.check(p2_y, "p2_y", torch.int16, (h, w))
    _native.check(p2_x, "p2_x", torch.int16, (h, w))
    total = torch.zeros((h, w, D), dtype=torch.int32, device=vol.device)
    _native.launch(
        "svt_sgm_paths", vol.device, vol.data_ptr(), vol.element_size(), p2_y.data_ptr(),
        p2_x.data_ptr(), total.data_ptr(), h, w, D, int(p1), num_paths,
    )
    sgm_aggregate_paths.launches += 1
    # int32 sums wrap into the int16 storage dtype exactly as the reference's
    # int16 partial sums do (two's-complement arithmetic is modular)
    return total.to(sum_dtype(vol.dtype))


sgm_aggregate_paths.launches = 0
