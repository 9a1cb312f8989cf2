"""SGM path scans on the card: kernels K2/K3 (integer costs), K7 (float
costs) and the twins of the reference's other sweep entry points, K10-K12
(twins of the sweep kernels of ``stereovisionarray_tpu/ops/sgm_pallas.py``).

``csrc/sgm_paths.cu`` holds two kernel families, both one warp per path line
with D across the lanes:

 - integer costs (K2/K3: ``_sweep_kernel_hdw_stacked``, ``_sweep_kernel_hdw``
   and the sweep half of ``_rl_extract_kernel``): every path adds into one
   int32 total with atomics, exact in any order; plain twin
   ``ops/sgm.aggregate_paths``;
 - float32 costs (K7, the float use of the same sweep kernels through
   ``sgm_aggregate_pallas_sweeps``): each path writes a partial of its own,
   and an ordered combine sums them per element in the order of the
   reference route (``ops/sgm.ORDERS``), fused multiply-adds included; plain
   twin ``ops/sgm.aggregate_paths_float``.

K10 (``sgm_aggregate_hwd``, twin of ``sgm_aggregate_pallas``), K11
(``sweep_pair``, twin of ``_sweep_hdw_bidir``) and K12 (``sgm_extract_fused``,
twin of ``sgm_extract_fused_hdw``) run on the same kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend
from stereovisionarray_tpu_torch.ops.sgm import (
    ALL_SWEEPS,
    ORDERS,
    aggregate_paths,
    aggregate_paths_float,
    check_sweeps,
    combine_partials,
    p2_maps,
    path_partials,
    sum_dtype,
    sweep_paths,
)

MAX_DISPARITIES = 256  # 8 values a lane
_SWEEP_BITS = {"down": 1, "up": 2, "lr": 4, "rl": 8}


def _check_disparities(D: int) -> None:
    if not 3 <= D <= MAX_DISPARITIES:
        raise ValueError(f"num_disparities must be in [3, {MAX_DISPARITIES}], got {D}")


def _launch_int(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                num_paths: int) -> torch.Tensor:
    """One launch of the integer path scans: the (H, W, D) int32 sum."""
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    h, w, D = vol.shape
    _check_disparities(D)
    _native.check(vol, "vol", vol.dtype, (h, w, D))
    _native.check(p2_y, "p2_y", torch.int16, (h, w))
    _native.check(p2_x, "p2_x", torch.int16, (h, w))
    total = torch.zeros((h, w, D), dtype=torch.int32, device=vol.device)
    _native.launch(
        "svt_sgm_paths", vol.device, vol.data_ptr(), vol.element_size(), p2_y.data_ptr(),
        p2_x.data_ptr(), total.data_ptr(), h, w, D, int(p1), num_paths,
    )
    return total


def _check_integer(vol: torch.Tensor) -> None:
    if vol.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"the integer path scans take int8 or int16 costs, got {vol.dtype}"
                        " (float32 costs: sgm_aggregate_float)")


def sgm_aggregate_paths(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor,
                        p1, num_paths: int = 8, backend: str = "auto") -> torch.Tensor:
    """K2/K3: (H, W, D) int8/int16 costs -> the int16 sum over the SGM paths;
    p2_y/p2_x (H, W) int16 and p1 in cost units."""
    _check_integer(vol)
    if resolve_backend(vol, backend) != "cuda":
        return aggregate_paths(vol, p2_y, p2_x, p1, num_paths)
    total = _launch_int(vol, p2_y, p2_x, p1, num_paths)
    sgm_aggregate_paths.launches += 1
    # int32 sums wrap into the int16 storage dtype exactly as the reference's
    # int16 partial sums do (two's-complement arithmetic is modular)
    return total.to(sum_dtype(vol.dtype))


sgm_aggregate_paths.launches = 0


def _float_partials(vol, p2_y, p2_x, p1, path_ids):
    """Launch the float path scans over `path_ids`: (partial, path_mask)."""
    h, w, D = vol.shape
    _check_disparities(D)
    _native.check(vol, "vol", torch.float32, (h, w, D))
    _native.check(p2_y, "p2_y", torch.float32, (h, w))
    _native.check(p2_x, "p2_x", torch.float32, (h, w))
    mask = sum(1 << pid for pid in set(path_ids))
    partial = torch.empty((len(set(path_ids)), h, w, D), dtype=torch.float32, device=vol.device)
    _native.launch("svt_sgm_paths_f32", vol.device, vol.data_ptr(), p2_y.data_ptr(),
                   p2_x.data_ptr(), partial.data_ptr(), h, w, D, float(p1), mask)
    return partial, mask


def _combine(partial, mask, num_paths, sweeps, order):
    """Launch the ordered combine of `partial` over `sweeps`."""
    _, h, w, D = partial.shape
    out = torch.empty((h, w, D), dtype=torch.float32, device=partial.device)
    _native.launch("svt_sgm_combine_f32", partial.device, partial.data_ptr(), out.data_ptr(),
                   h, w, D, mask, num_paths, sum(_SWEEP_BITS[s] for s in sweeps),
                   ORDERS.index(order))
    return out


def _launch_float(vol, p2_y, p2_x, p1, num_paths, sweeps, order):
    """The float path scans over `sweeps`, then their ordered combine."""
    groups = sweep_paths(num_paths)
    partial, mask = _float_partials(vol, p2_y, p2_x, p1, [p for s in sweeps for p in groups[s]])
    return _combine(partial, mask, num_paths, sweeps, order)


def sgm_aggregate_float(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                        num_paths: int = 8, sweeps=ALL_SWEEPS, order: str = "k7",
                        backend: str = "auto") -> torch.Tensor:
    """K7: the float32 SGM sum over `sweeps` of an (H, W, D) float32 volume,
    in `order` (``ops/sgm.ORDERS``); p2_y/p2_x (H, W) float32, p1 a float.
    ``sweeps`` is the reference's ``sgm_aggregate_pallas_sweeps`` subset (k7
    order only); the sums over a split of the four add up to the whole."""
    sweeps = check_sweeps(sweeps, order)
    if resolve_backend(vol, backend) != "cuda":
        return aggregate_paths_float(vol, p2_y, p2_x, p1, num_paths, sweeps, order)
    out = _launch_float(vol, p2_y, p2_x, p1, num_paths, sweeps, order)
    sgm_aggregate_float.launches += 1
    return out


sgm_aggregate_float.launches = 0


def sgm_aggregate_hwd(vol: torch.Tensor, p1: float = 8.0, p2: float = 96.0,
                      num_paths: int = 8, image: Optional[torch.Tensor] = None,
                      adaptive_p2: bool = False, p2_min: float = 24.0,
                      backend: str = "auto") -> torch.Tensor:
    """K10, twin of the reference's ``sgm_aggregate_pallas`` over an (H, W, D)
    volume. float32: the k10 order (every add rounded, no fused row). int16:
    the integer kernel, the sum in the volume's dtype (the reference carries
    int16 volumes in int16, which equals int32 arithmetic narrowed while no
    path value overflows). int8 is refused: the reference carries it in int8
    and wraps."""
    if vol.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"sgm_aggregate_hwd takes int16 or float32 volumes, got {vol.dtype}")
    h, w, _ = vol.shape
    p2_y, p2_x = p2_maps((h, w), p2, vol.dtype, vol.device, image, adaptive_p2, p2_min)
    floating = vol.dtype == torch.float32
    if resolve_backend(vol, backend) != "cuda":
        if floating:
            return aggregate_paths_float(vol, p2_y, p2_x, p1, num_paths, ALL_SWEEPS, "k10")
        return aggregate_paths(vol, p2_y, p2_x, p1, num_paths)
    out = (_launch_float(vol, p2_y, p2_x, p1, num_paths, ALL_SWEEPS, "k10") if floating
           else _launch_int(vol, p2_y, p2_x, p1, num_paths).to(vol.dtype))
    sgm_aggregate_hwd.launches += 1
    return out


sgm_aggregate_hwd.launches = 0


def sweep_pair(vol: torch.Tensor, p2_map: torch.Tensor, p1: float, diagonals: bool = True,
               backend: str = "auto"):
    """K11, twin of the reference's ``_sweep_hdw_bidir``: the forward and the
    backward sweep along axis 0 of an (S, N, D) float32 volume, each its
    group's sum ((axis + diag+1) + diag-1 with `diagonals`, else the axis
    path), P2 from the (S, N) float32 `p2_map` on every path. For the
    horizontal pair pass the volume with its first two axes swapped."""
    num_paths = 8 if diagonals else 4
    groups = sweep_paths(num_paths)
    if resolve_backend(vol, backend) != "cuda":
        parts = path_partials(vol, p2_map, p2_map, p1, groups["down"] + groups["up"])
        return tuple(combine_partials(parts, num_paths, (s,)) for s in ("down", "up"))
    partial, mask = _float_partials(vol, p2_map, p2_map, p1, groups["down"] + groups["up"])
    out = tuple(_combine(partial, mask, num_paths, (s,), "k7") for s in ("down", "up"))
    sweep_pair.launches += 1
    return out


sweep_pair.launches = 0


def sgm_extract_fused(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                      num_paths: int = 8, subpixel: bool = True, uniqueness: float = 0.0,
                      lr_max_diff: float = 0.0, backend: str = "auto"):
    """K12, twin of the reference's ``sgm_extract_fused_hdw``: the SGM sum in
    the k12 order (float32; int8/int16 sums are order-free), then extraction
    with the in-volume LR check. Returns ``extract_cuda.DisparityMaps``
    (disparity before masking, cost, valid, second)."""
    from stereovisionarray_tpu_torch.ops import extract_cuda

    floating = vol.dtype == torch.float32
    if not floating:
        _check_integer(vol)
    if resolve_backend(vol, backend) != "cuda":
        total = (aggregate_paths_float(vol, p2_y, p2_x, p1, num_paths, ALL_SWEEPS, "k12")
                 if floating else aggregate_paths(vol, p2_y, p2_x, p1, num_paths))
        return extract_cuda.extract_disparity_maps(total, subpixel, uniqueness, lr_max_diff,
                                                   backend)
    total = (_launch_float(vol, p2_y, p2_x, p1, num_paths, ALL_SWEEPS, "k12") if floating
             else _launch_int(vol, p2_y, p2_x, p1, num_paths).to(sum_dtype(vol.dtype)))
    maps = extract_cuda.launch_disparity_maps(total, subpixel, uniqueness, lr_max_diff)
    sgm_extract_fused.launches += 1
    return maps


sgm_extract_fused.launches = 0
