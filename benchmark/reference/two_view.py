"""Plain reference of rectified two-view SGM on integer costs: census + BT
cost volume, 4/8-path SGM, WTA with the parabola, uniqueness, the
left-right check and PKRN confidence.

A frozen copy of the plain twins of ``stereovisionarray_tpu_torch``'s
integer route (``ops/cost_volume.fused_cost_volume``, ``models/two_view``):
on the same device it gives the bits of the port's kernels K1, K2/K3 and K4
with K5's check. It derives every penalty and scale from the configuration
itself and imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import plain

COST_SCALE = {"int16": 4, "int8": 1}


def worst_cost(window, bt_weight: float, bt_clip: float) -> float:
    return float(window[0] * window[1] - 1) + (bt_weight * bt_clip if bt_weight > 0.0 else 0.0)


def cost_dtype(cost: dict) -> str:
    """int8 widens to int16 when the window's worst cost does not fit int8."""
    if cost["dtype"] == "int8" and worst_cost(cost["census_window"], cost["bt_weight"],
                                              cost["bt_clip"]) > 127.0:
        return "int16"
    return cost["dtype"]


def half_pixel_bounds(img: torch.Tensor):
    """Min and max of each pixel and its half-pixel neighbours along x; the
    neighbours wrap around the row."""
    lh = 0.5 * (img + torch.roll(img, 1, dims=-1))
    rh = 0.5 * (img + torch.roll(img, -1, dims=-1))
    return (torch.minimum(torch.minimum(lh, rh), img), torch.maximum(torch.maximum(lh, rh), img))


def cost_volume(left: torch.Tensor, right: torch.Tensor, cost: dict) -> torch.Tensor:
    """(H, W, D) census Hamming + bt_weight * Birchfield-Tomasi, an
    out-of-image candidate (x < d) at the worst cost, quantized as
    ``round(cost * scale)`` (half to even) into the integer dtype."""
    D, window = cost["num_disparities"], tuple(cost["census_window"])
    bt_weight, clip = cost["bt_weight"], cost["bt_clip"]
    dtype = cost_dtype(cost)
    n_bits = window[0] * window[1] - 1
    h, w = left.shape
    xs = torch.arange(w, device=left.device)
    cl, cr = plain.census_transform(left, window), plain.census_transform(right, window)
    vol = torch.stack([torch.where(xs < d, n_bits, plain.hamming(cl, cr[:, (xs - d).clamp(0, w - 1)]))
                       for d in range(D)], dim=-1)
    if bt_weight > 0.0:
        r_mn, r_mx = half_pixel_bounds(right)
        l_mn, l_mx = half_pixel_bounds(left)
        slices = []
        for d in range(D):
            src = (xs - d).clamp(0, w - 1)
            rs, rmn, rmx = right[:, src], r_mn[:, src], r_mx[:, src]
            d_lr = torch.clamp_min(torch.maximum(left - rmx, rmn - left), 0.0)
            d_rl = torch.clamp_min(torch.maximum(rs - l_mx, l_mn - rs), 0.0)
            c = torch.clamp_max(torch.minimum(d_lr, d_rl), clip)
            slices.append(torch.where(xs < d, clip, c))
        vol = vol + bt_weight * torch.stack(slices, dim=-1)
    oob = xs[:, None] < torch.arange(D, device=left.device)[None, :]
    vol = torch.where(oob, worst_cost(window, bt_weight, clip), vol)
    return torch.round(vol * COST_SCALE[dtype]).to(getattr(torch, dtype))


def disparity(left: torch.Tensor, right: torch.Tensor, cfg: Dict) -> Dict[str, torch.Tensor]:
    """The maps of an (H, W) rectified pair under ``cfg`` (the ``engine``
    group of a configuration file: ``cost`` and ``sgm``): disparity (-1
    where rejected), valid, the winning cost and PKRN confidence."""
    cost, sgm = cfg["cost"], cfg["sgm"]
    scale = COST_SCALE[cost_dtype(cost)]
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    vol = cost_volume(left, right, cost)
    p2_y, p2_x = plain.p2_maps(left, round(sgm["p2"] * scale), round(sgm["p2_min"] * scale),
                               sgm["adaptive_p2"])
    total = plain.sgm_total(vol, p2_y, p2_x, round(sgm["p1"] * scale), sgm["num_paths"])
    del vol
    maps = plain.extract_maps(total, sgm["subpixel"], max(sgm["uniqueness"], 0.0),
                              max(sgm["lr_max_diff"], 0.0))
    valid = maps.valid
    conf = plain.pkrn_confidence(maps.cost, maps.second, valid)
    return {"disparity": torch.where(valid, maps.disparity, plain.INVALID_DISPARITY),
            "valid": valid, "cost": maps.cost, "confidence": torch.where(valid, conf, 0.0)}
