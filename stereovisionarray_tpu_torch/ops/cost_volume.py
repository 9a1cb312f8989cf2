"""Rectified census + Birchfield-Tomasi cost volume, plain PyTorch
(twin of ``stereovisionarray_tpu/ops/cost_volume.py``).

Layout is (H, W, D), the reference's public layout:
``cost[y, x, d]`` compares left pixel x with right pixel x - d. Float volumes
follow the reference's XLA builder; integer volumes (int16 at scale 4, int8 at
scale 1) follow its Pallas builders (``ops/cost_pallas.py``) bit for bit: the
cost is built in float32, out-of-image candidates (x < d) get the worst cost,
and ``round(cost * scale)`` (half to even) is stored. The CUDA kernel that
builds the integer volume is ``ops/cost_cuda.py``.

:func:`census_cost_volume` and :func:`birchfield_tomasi_volume` are the
reference's separate builders of its XLA route, each with the ``d_offset``
hook of the disparity split and ``out_axes`` (1 gives (H, D, W));
:func:`fused_cost_volume`, the plain twin of the CUDA kernel (K1), is their
weighted sum, quantized for the integer dtypes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereovisionarray_tpu_torch.ops.census import census_transform, hamming_distance

# integer cost mode: fixed-point scale so 0.25-weighted BT terms stay exact
COST_SCALE = 4

_DTYPES = {"float32": torch.float32, "int16": torch.int16, "int8": torch.int8}


def as_dtype(dtype) -> torch.dtype:
    """A cost dtype given as torch dtype or as the config's string."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise TypeError(f"unsupported cost dtype {dtype}")
        return dtype
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported cost dtype {dtype!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def int8_cost_fits(census_window, bt_weight: float, bt_clip: float) -> bool:
    """True when the worst-case cost (all census bits + clipped BT) fits int8
    at scale 1 (7x9: 62 + 0.25*32 = 70; 11x13: 142 + 8 = 150 does not)."""
    wh, ww = census_window
    worst = (wh * ww - 1) + (bt_weight * bt_clip if bt_weight > 0.0 else 0.0)
    return worst <= 127.0


def cost_scale_for(dtype) -> int:
    """Fixed-point scale of an integer cost dtype: int16 -> 4, int8 -> 1;
    float dtypes scale by 1."""
    return COST_SCALE if as_dtype(dtype) == torch.int16 else 1


def worst_cost(census_window, bt_weight: float, bt_clip: float) -> float:
    """Cost of an out-of-image candidate: every census bit plus the clipped BT
    term (computed in double, as the reference's kernels compute it)."""
    wh, ww = census_window
    return float(wh * ww - 1) + (bt_weight * bt_clip if bt_weight > 0.0 else 0.0)


def half_pixel_bounds(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max of each pixel and its two half-pixel neighbours along x. The
    neighbours wrap around (x = 0 reads x = W - 1), as ``jnp.roll`` does."""
    lh = 0.5 * (img + torch.roll(img, 1, dims=-1))
    rh = 0.5 * (img + torch.roll(img, -1, dims=-1))
    mn = torch.minimum(torch.minimum(lh, rh), img)
    mx = torch.maximum(torch.maximum(lh, rh), img)
    return mn, mx


def _shift_index(w: int, d: int, device) -> torch.Tensor:
    """Edge-clamped source columns of a shift by `d`: ``clip(x - d, 0, W - 1)``."""
    return (torch.arange(w, device=device) - d).clamp(0, w - 1)


def census_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    window: Tuple[int, int] = (7, 9),
    dtype=torch.float32,
    d_offset: int = 0,
    out_axes: int = -1,
) -> torch.Tensor:
    """(H, W, D) census Hamming volume of a rectified pair, in `dtype`:
    ``cost[y, x, d] = hamming(census_L[y, x], census_R[y, x - d])`` over the
    disparities ``d_offset .. d_offset + D - 1``; an out-of-image candidate
    (x < d) costs every census bit. ``out_axes`` places the disparity axis
    (1: (H, D, W))."""
    out_dtype = as_dtype(dtype)
    wh, ww = window
    n_bits = wh * ww - 1
    cl = census_transform(left, window)  # (H, W, P)
    cr = census_transform(right, window)
    w = left.shape[-1]
    xs = torch.arange(w, device=left.device)
    slices = []
    for d in range(d_offset, d_offset + num_disparities):
        c = hamming_distance(cl, cr[:, _shift_index(w, d, left.device)], dtype=out_dtype)
        slices.append(torch.where(xs < d, n_bits, c))
    return torch.stack(slices, dim=out_axes)


def birchfield_tomasi_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    clip: float = 32.0,
    dtype=torch.float32,
    d_offset: int = 0,
    out_axes: int = -1,
) -> torch.Tensor:
    """(H, W, D) Birchfield-Tomasi sampling-insensitive absolute difference
    over the disparities ``d_offset .. d_offset + D - 1``, clipped at `clip`
    (an out-of-image candidate costs `clip`); ``out_axes`` as in
    :func:`census_cost_volume`.

    The result is float32 for every `dtype`, as the reference's is: an
    integer `dtype` only converts the images first, saturating (int8 holds
    intensities up to 127), and their half-pixel sums are taken in that
    integer type, wrapping as the reference's do."""
    out_dtype = as_dtype(dtype)
    fill = clip
    if out_dtype != torch.float32:
        info = torch.iinfo(out_dtype)
        left = left.clamp(info.min, info.max).to(out_dtype)
        right = right.clamp(info.min, info.max).to(out_dtype)
        fill = float(min(max(int(clip), info.min), info.max))  # the fill in that type
    else:
        left, right = left.to(torch.float32), right.to(torch.float32)
    r_mn, r_mx = half_pixel_bounds(right)
    l_mn, l_mx = half_pixel_bounds(left)
    w = left.shape[-1]
    xs = torch.arange(w, device=left.device)
    slices = []
    for d in range(d_offset, d_offset + num_disparities):
        src = _shift_index(w, d, left.device)
        rs, rmn, rmx = right[:, src], r_mn[:, src], r_mx[:, src]
        d_lr = torch.clamp_min(torch.maximum(left - rmx, rmn - left), 0.0)
        d_rl = torch.clamp_min(torch.maximum(rs - l_mx, l_mn - rs), 0.0)
        c = torch.clamp_max(torch.minimum(d_lr, d_rl), clip)
        slices.append(torch.where(xs < d, fill, c))
    return torch.stack(slices, dim=out_axes)


def fused_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    census_window: Tuple[int, int] = (7, 9),
    bt_weight: float = 0.25,
    bt_clip: float = 32.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """(H, W, D) census Hamming + ``bt_weight`` * Birchfield-Tomasi cost.

    The sum of the two separate builders: it holds both float32 (H, W, D)
    volumes at once, and on the integer routes their sum, the masked volume
    and the rounded one too, about four volumes of float32 at its peak."""
    out_dtype = as_dtype(dtype)
    if out_dtype == torch.int8 and not int8_cost_fits(census_window, bt_weight, bt_clip):
        raise ValueError(f"census window {census_window} + bt overflows int8; use int16")
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    vol = census_cost_volume(left, right, num_disparities, census_window)
    if bt_weight > 0.0:
        vol = vol + bt_weight * birchfield_tomasi_volume(left, right, num_disparities,
                                                         clip=bt_clip)
    if out_dtype == torch.float32:
        return vol
    # the Pallas builders: an out-of-image candidate costs the worst cost,
    # then round(cost * scale), half to even
    w = left.shape[-1]
    oob = torch.arange(w, device=left.device)[:, None] < torch.arange(
        num_disparities, device=left.device)[None, :]
    vol = torch.where(oob, worst_cost(census_window, bt_weight, bt_clip), vol)
    return torch.round(vol * cost_scale_for(out_dtype)).to(out_dtype)


def right_from_left_volume(vol: torch.Tensor) -> torch.Tensor:
    """The right camera's volume from the left one, edge-clamped:
    ``cost_R[y, x, d] = cost_L[y, min(x + d, W - 1), d]``."""
    h, w, D = vol.shape
    idx = (torch.arange(w, device=vol.device)[:, None]
           + torch.arange(D, device=vol.device)[None, :]).clamp(max=w - 1)
    return torch.gather(vol, 1, idx.expand(h, w, D))
