"""The cost volume on the card: kernel K1 (twin of
``stereovisionarray_tpu/ops/cost_pallas.py``).

One CUDA kernel (``csrc/cost_volume.cu``) replaces both TPU builders,
``fused_cost_volume_pallas_wdh`` and ``fused_cost_volume_pallas_hdw``; it
writes the (H, W, D) layout directly: int8 or int16 fixed-point costs, or
unscaled float32 costs (the reference's XLA float cost volume, which the
float route of the two-view pipeline reads). Its plain twin is
``ops/cost_volume.fused_cost_volume``.

The kernel has a tiled form: a CTA stages the census window's rows of C
pixels and their D - 1 halo in shared memory, builds each census code and BT
triple once, and sweeps each pixel's disparities in runs of one 8- or
16-byte store, which a warp gathers in shared memory and writes out as whole
chunks of its 32 pixels' rows. :func:`_tile_plan` picks C and lays out the
shared memory; where no tile fits (D * size not a multiple of 8, or a stage
too large for shared memory) the launch runs the generic form, the untiled
kernel (tile 0). No path of the port gives it such a shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

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
TILES = (256, 128, 64)  # left pixels (threads) a CTA of the tiled kernel, widest first
SMEM_LIMIT = 232448  # the 227 KB of shared memory an H100 block can use
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_CTAS_PER_SM = 2  # full tiles a row set must give each SM before a wider tile is taken
CHUNK_MAX = 128  # bytes of a pixel's volume a warp writes out at once


class TilePlan(NamedTuple):
    """One launch of the tiled kernel: grid (per_row, H), `tile` threads a
    CTA, and its shared memory. Region 0 holds the staged rows (win_h rows
    of `left_cols` then `right_cols` floats) until the codes are built, then
    the warps' out buffers (32 pixels x K runs a warp); the codes ([n_words]
    [n_px] 64-bit words at `codes_offset`) and the BT triples ([3][n_px]
    floats at `bt_offset`) of the C left pixels, then the C + D - 1 right
    ones, follow."""

    tile: int  # C: left pixels a CTA, one a thread
    per_row: int  # CTAs a row
    run: int  # V: disparities a thread computes at once
    run_bytes: int  # V * element size: 16, or 8 where D * size is not a multiple of 16
    chunk_runs: int  # K: runs of a pixel a warp buffers, then writes out whole
    margin: int  # m = max(pw, 1): staged columns each side of a pixel
    lead_left: int  # columns staged before x0 - m, so the span starts at a multiple of 4
    lead_right: int  # the same before x0 - (D - 1) - m
    left_cols: int  # staged columns of the left image, a multiple of 4
    right_cols: int  # staged columns of the right image, a multiple of 4
    n_px: int  # pixels with a code: C left and C + D - 1 right
    codes_offset: int
    bt_offset: int
    smem_bytes: int


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def _layout(tile: int, n_disp: int, census_window, element_size: int, w: int) -> TilePlan:
    """The tiled kernel's shared-memory layout at tile C (csrc/cost_volume.cu
    tile_shape computes the same). A chunk is the widest power of two up to
    ``CHUNK_MAX`` bytes dividing a pixel's row (16-byte runs), or the whole
    row where its 8-byte runs make at most ``CHUNK_MAX`` bytes."""
    wh, ww = census_window
    n_words = -(-(wh * ww - 1) // 64)
    margin = max(ww // 2, 1)
    lead_left = -margin % 4  # x0 is a multiple of 4
    lead_right = -(n_disp - 1 + margin) % 4
    left_cols = _round4(lead_left + tile + 2 * margin)
    right_cols = _round4(lead_right + tile + n_disp - 1 + 2 * margin)
    n_px = 2 * tile + n_disp - 1
    row_bytes = n_disp * element_size
    run_bytes = 16 if row_bytes % 16 == 0 else 8
    chunk = run_bytes
    if run_bytes == 16:
        while chunk < CHUNK_MAX and row_bytes % (2 * chunk) == 0:
            chunk *= 2
    elif row_bytes <= CHUNK_MAX:
        chunk = row_bytes
    codes_offset = max(wh * (left_cols + right_cols) * 4, tile * chunk)
    bt_offset = codes_offset + n_words * n_px * 8
    return TilePlan(tile, -(-w // tile), run_bytes // element_size, run_bytes,
                    chunk // run_bytes, margin, lead_left, lead_right, left_cols, right_cols,
                    n_px, codes_offset, bt_offset, bt_offset + 3 * n_px * 4)


@functools.lru_cache(maxsize=256)
def _tile_plan(h: int, w: int, n_disp: int, census_window: Tuple[int, int],
               element_size: int) -> Optional[TilePlan]:
    """The tiled kernel's plan for an (h, w, n_disp) volume of `element_size`
    bytes, or None (the generic form) where D * size is not a multiple of 8
    or no tile's shared memory fits ``SMEM_LIMIT``. C is the widest of
    ``TILES`` that fits and whose full tiles keep at least
    ``MIN_CTAS_PER_SM`` CTAs an SM busy (h * (w // C) >= 2 * 132: 256 at
    540x768, 128 at 256x384); where none does, the narrowest that fits."""
    if n_disp * element_size % 8:
        return None
    plans = [p for p in (_layout(t, n_disp, census_window, element_size, w) for t in TILES)
             if p.smem_bytes <= SMEM_LIMIT]
    for p in plans:
        if h * (w // p.tile) >= MIN_CTAS_PER_SM * SMS:
            return p
    return plans[-1] if plans else None


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
    plan = _tile_plan(h, w, num_disparities, (wh, ww), out.element_size())
    _native.launch(
        "svt_cost_volume", left.device, left.data_ptr(), right.data_ptr(), out.data_ptr(),
        out.element_size(), h, w, num_disparities, wh, ww, float(bt_weight),
        float(bt_clip), float(worst), float(cost_scale_for(out_dtype)),
        plan.tile if plan is not None else 0,
    )
    fused_cost_volume_cuda.launches += 1
    return out


fused_cost_volume_cuda.launches = 0
