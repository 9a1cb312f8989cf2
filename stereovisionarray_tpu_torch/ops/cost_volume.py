"""Rectified census + Birchfield-Tomasi cost volume, plain PyTorch
(twin of ``stereovisionarray_tpu/ops/cost_volume.py``).

Layout is (H, W, D), the reference's public layout:
``cost[y, x, d]`` compares left pixel x with right pixel x - d. Float volumes
follow the reference's XLA builder; integer volumes (int16 at scale 4, int8 at
scale 1) follow its Pallas builders (``ops/cost_pallas.py``) bit for bit: the
cost is built in float32, out-of-image candidates (x < d) get the worst cost,
and ``round(cost * scale)`` (half to even) is stored. The CUDA kernel that
builds the integer volume is ``ops/cost_cuda.py``.
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


def fused_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    census_window: Tuple[int, int] = (7, 9),
    bt_weight: float = 0.25,
    bt_clip: float = 32.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """(H, W, D) census Hamming + ``bt_weight`` * Birchfield-Tomasi cost."""
    out_dtype = as_dtype(dtype)
    integer = out_dtype != torch.float32
    if out_dtype == torch.int8 and not int8_cost_fits(census_window, bt_weight, bt_clip):
        raise ValueError(f"census window {census_window} + bt overflows int8; use int16")
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    h, w = left.shape
    wh, ww = census_window
    n_bits = wh * ww - 1
    worst = worst_cost(census_window, bt_weight, bt_clip)
    scale = cost_scale_for(out_dtype)
    use_bt = bt_weight > 0.0

    cl = census_transform(left, census_window)  # (H, W, P)
    cr = census_transform(right, census_window)
    if use_bt:
        l_mn, l_mx = half_pixel_bounds(left)
        r_mn, r_mx = half_pixel_bounds(right)

    xs = torch.arange(w, device=left.device)
    slices = []
    for d in range(num_disparities):
        src = (xs - d).clamp(min=0)  # right pixel x - d, edge-clamped under the mask
        oob = xs < d  # (W,), broadcasts over rows
        ham = hamming_distance(cl, cr[:, src])
        if use_bt:
            rs, rmn, rmx = right[:, src], r_mn[:, src], r_mx[:, src]
            d_lr = torch.clamp_min(torch.maximum(left - rmx, rmn - left), 0.0)
            d_rl = torch.clamp_min(torch.maximum(rs - l_mx, l_mn - rs), 0.0)
            bt = torch.clamp_max(torch.minimum(d_lr, d_rl), bt_clip)
        if integer:
            cost = ham + bt_weight * bt if use_bt else ham
            cost = torch.where(oob, worst, cost)
            slices.append(torch.round(cost * scale).to(out_dtype))
        else:
            cost = torch.where(oob, float(n_bits), ham)
            if use_bt:
                cost = cost + bt_weight * torch.where(oob, bt_clip, bt)
            slices.append(cost)
    return torch.stack(slices, dim=-1)


def right_from_left_volume(vol: torch.Tensor) -> torch.Tensor:
    """The right camera's volume from the left one, edge-clamped:
    ``cost_R[y, x, d] = cost_L[y, min(x + d, W - 1), d]``."""
    h, w, D = vol.shape
    idx = (torch.arange(w, device=vol.device)[:, None]
           + torch.arange(D, device=vol.device)[None, :]).clamp(max=w - 1)
    return torch.gather(vol, 1, idx.expand(h, w, D))
