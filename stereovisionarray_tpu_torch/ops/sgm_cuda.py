"""SGM path scans on the card: kernels K2/K3 (integer costs), K7 (float
costs) and the twins of the reference's other sweep entry points, K10-K12
(twins of the sweep kernels of ``stereovisionarray_tpu/ops/sgm_pallas.py``).

``csrc/sgm_paths.cu`` holds two kernel families, both a group of lanes per
path line with D across its lanes:

 - integer costs (K2/K3: ``_sweep_kernel_hdw_stacked``, ``_sweep_kernel_hdw``
   and the sweep half of ``_rl_extract_kernel``): each pair of opposite
   paths walks its lines (both ways, or each way on its own) into an int16
   buffer of its own with plain reads and writes, all at once, and a sum
   pass adds the buffers into the int16 total (``ops/sgm.sum_dtype``); int16
   addition wraps, which equals the int32 sum narrowed, in any order of
   adds; plain twin ``ops/sgm.aggregate_paths``;
 - float32 costs (K7, the float use of the same sweep kernels through
   ``sgm_aggregate_pallas_sweeps``), summed per element in the order of the
   reference route (``ops/sgm.ORDERS``), fused multiply-adds included; plain
   twin ``ops/sgm.aggregate_paths_float``. Two routes:
   - the strip route (``svt_sgm_float_strips``, every call over all four
     sweeps where :func:`_strip_plan` gives a strip height S): the
     horizontal walks into two buffers; then the down group and the up group
     each walk the image in strips of S rows, each in a cooperative launch,
     their three path partials kept in a two-slot ring that stays in L2, each
     strip's group sum taken while the next strip walks; the up pass writes
     the route's total;
   - the generic form (sweep subsets, D % 8 != 0, unaligned costs): each
     path writes a partial of its own, then an ordered combine.

K10 (``sgm_aggregate_hwd``, twin of ``sgm_aggregate_pallas``), K11
(``sweep_pair``, twin of ``_sweep_hdw_bidir``) and K12 (``sgm_extract_fused``,
twin of ``sgm_extract_fused_hdw``) run on the same kernels: K10 and K12 on
the strip route, K11 (a sweep pair) on the generic form.
"""

from __future__ import annotations

import functools
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
    sweep_paths,
)

MAX_DISPARITIES = 256  # 8 values a lane
_SWEEP_BITS = {"down": 1, "up": 2, "lr": 4, "rl": 8}
# K7's strip route: the ring holds two slots of the three path partials of a
# vertical group over S rows, and is kept within about half the H100's 50 MB L2
STRIP_RING_BYTES = 24 << 20
MAX_STRIP_ROWS = 32


def _check_disparities(D: int) -> None:
    if not 3 <= D <= MAX_DISPARITIES:
        raise ValueError(f"num_disparities must be in [3, {MAX_DISPARITIES}], got {D}")


def scratch_partials(num_paths: int) -> int:
    """int16 partial buffers beside the total that the integer scans write
    (``csrc/sgm_paths.cu`` scratch_partials): every walk runs at once, the
    vertical family into the total, each other walk into a partial that a
    sum pass adds in."""
    return 4 if num_paths == 8 else 2


def _launch_int(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                num_paths: int) -> torch.Tensor:
    """The integer path scans: the (H, W, D) sum in the int16 storage dtype,
    written by the kernels (one entry point, two launches in stream order)."""
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    h, w, D = vol.shape
    _check_disparities(D)
    _native.check(vol, "vol", vol.dtype, (h, w, D))
    _native.check(p2_y, "p2_y", torch.int16, (h, w))
    _native.check(p2_x, "p2_x", torch.int16, (h, w))
    total = torch.empty((h, w, D), dtype=torch.int16, device=vol.device)
    scratch = torch.empty((scratch_partials(num_paths), h, w, D), dtype=torch.int16,
                          device=vol.device)
    _native.launch(
        "svt_sgm_paths", vol.device, vol.data_ptr(), vol.element_size(), p2_y.data_ptr(),
        p2_x.data_ptr(), total.data_ptr(), scratch.data_ptr(), h, w, D, int(p1), num_paths,
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
    return _launch_int(vol, p2_y, p2_x, p1, num_paths)


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


@functools.lru_cache(maxsize=256)
def _strip_plan(h: int, w: int, D: int, num_paths: int, sweeps: tuple,
                aligned: bool) -> Optional[int]:
    """K7's strip height S for an (h, w, D) float sum over `sweeps`, or None
    for the generic form: a sweep subset, D % 8 != 0 (a lane holds 4 or 8
    consecutive d as 16-byte words) or costs not 16-byte aligned. S is
    the largest power of two <= 32 whose ring, 2 slots x 3 paths x S rows of
    w * D floats, fits in ``STRIP_RING_BYTES`` (1 where none does). It does
    not depend on h or on `num_paths`: 4 paths fill a third of the ring."""
    if tuple(sweeps) != ALL_SWEEPS or D % 8 or not aligned:
        return None
    rows = MAX_STRIP_ROWS
    while rows > 1 and 2 * 3 * rows * w * D * 4 > STRIP_RING_BYTES:
        rows //= 2
    return rows


def _launch_strips(vol, p2_y, p2_x, p1, num_paths, order, strip_rows):
    """K7's strip route: one entry point, three launches in stream order
    (the horizontal walks, the down pass, the up pass with the combine)."""
    h, w, D = vol.shape
    _check_disparities(D)
    _native.check(vol, "vol", torch.float32, (h, w, D))
    _native.check(p2_y, "p2_y", torch.float32, (h, w))
    _native.check(p2_x, "p2_x", torch.float32, (h, w))
    f32 = dict(dtype=torch.float32, device=vol.device)
    out = torch.empty((h, w, D), **f32)
    scratch = torch.empty((3, h, w, D), **f32)  # left->right, right->left, the down group
    ring = torch.empty((2, 3 if num_paths == 8 else 1, strip_rows, w, D), **f32)
    _native.launch("svt_sgm_float_strips", vol.device, vol.data_ptr(), p2_y.data_ptr(),
                   p2_x.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
                   scratch[1].data_ptr(), scratch[2].data_ptr(), ring.data_ptr(), h, w, D,
                   float(p1), num_paths, ORDERS.index(order), strip_rows)
    return out


def _launch_float(vol, p2_y, p2_x, p1, num_paths, sweeps, order):
    """The float sum over `sweeps`: the strip route where :func:`_strip_plan`
    gives a strip height, else the generic form: the path scans over
    `sweeps`, then their ordered combine."""
    h, w, D = vol.shape
    strip_rows = _strip_plan(h, w, D, num_paths, tuple(sweeps), vol.data_ptr() % 16 == 0)
    if strip_rows is not None:
        return _launch_strips(vol, p2_y, p2_x, p1, num_paths, order, strip_rows)
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
    return _launch_float(vol, p2_y, p2_x, p1, num_paths, sweeps, order)


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
    return (_launch_float(vol, p2_y, p2_x, p1, num_paths, ALL_SWEEPS, "k10") if floating
            else _launch_int(vol, p2_y, p2_x, p1, num_paths))


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
    return tuple(_combine(partial, mask, num_paths, (s,), "k7") for s in ("down", "up"))


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
             else _launch_int(vol, p2_y, p2_x, p1, num_paths))
    return extract_cuda.launch_disparity_maps(total, subpixel, uniqueness, lr_max_diff)
