"""Harris corners and normalized-patch descriptors (twin of
``stereovisionarray_tpu/sfm/features.py``).

Every image yields exactly ``max_features`` corners (the top of the NMS'd
Harris response) with a validity mask, so detection batches over the views of
an array and the shapes never depend on the data.

The response follows the reference's float32 arithmetic as XLA compiles it
on the CPU: the Sobel taps as padded shifted adds, and the box filter's
cumulative sum in XLA's order (a sequential sum inside blocks of 16, the
block totals scanned the same way, recursively), divided by the window as a
product with its float32 reciprocal, and the determinant and the response
each one fused multiply-add (``ops.sgm.fmaf``). So the response, and with it the corner
set, matches the reference bit for bit. The top-k is a stable descending
sort: ties (NMS plateaus, and the -inf slots once fewer corners than
``max_features`` survive) go to the lower flat index, as ``lax.top_k`` orders
them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from stereovisionarray_tpu_torch.ops.sgm import fmaf

__all__ = ["Features", "describe_patches", "detect_features", "extract_features",
           "harris_response"]

# block length of XLA's rewrite of a cumulative sum into a blocked scan
_SCAN_BLOCK = 16


class Features(NamedTuple):
    uv: torch.Tensor  # (..., F, 2) float32 pixel coords (u = x, v = y), subpixel
    response: torch.Tensor  # (..., F) Harris response
    descriptor: torch.Tensor  # (..., F, K) L2-normalized patch descriptor
    valid: torch.Tensor  # (..., F) bool


def _pad_edge(x: torch.Tensor, pad) -> torch.Tensor:
    """Edge padding of the last two dims by (left, right, top, bottom)."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape(-1, 1, *x.shape[-2:]), pad, mode="replicate")
    return y.reshape(*lead, *y.shape[-2:])


def _sobel(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients of (..., H, W) images (edge-padded, separable)."""
    p = _pad_edge(image, (1, 1, 1, 1))
    sy = p[..., :-2, :] + 2.0 * p[..., 1:-1, :] + p[..., 2:, :]
    gx = (sy[..., :, 2:] - sy[..., :, :-2]) / 8.0
    sx = p[..., :, :-2] + 2.0 * p[..., :, 1:-1] + p[..., :, 2:]
    gy = (sx[..., 2:, :] - sx[..., :-2, :]) / 8.0
    return gx, gy


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last dim, one element after another."""
    acc = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., i])
    return torch.stack(acc, dim=-1)


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last dim in XLA's CPU order."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(x)
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(*x.shape[:-1], nb, _SCAN_BLOCK)
    scanned = _sequential_scan(blocks)
    before = _cumsum_last(scanned[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], dim=-1)
    return (scanned + before[..., None]).reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean of (..., H, W) (separable cumulative sums, edge-padded)."""
    p = k // 2
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)  # the float32 reciprocal XLA multiplies by

    def rows(a):  # along the last dim
        c = _cumsum_last(_pad_edge(a, (p + 1, p, 0, 0)))
        n = a.shape[-1]
        return (c[..., k:k + n] - c[..., :n]) * inv_k

    return rows(rows(x).transpose(-1, -2)).transpose(-1, -2)


def harris_response(image: torch.Tensor, k: float = 0.05, window: int = 5) -> torch.Tensor:
    """Harris response det(M) - k tr(M)^2 of the box-filtered structure tensor
    M = [[gx^2, gx gy], [gx gy, gy^2]] of (..., H, W) images."""
    gx, gy = _sobel(image.to(torch.float32))
    a, b, c = _box(torch.stack([gx * gx, gx * gy, gy * gy]), window).unbind(0)
    # XLA contracts both differences into fused multiply-adds
    det = fmaf(a, c, -(b * b))
    tr = a + c
    return fmaf(-(k * tr), tr, det)


def _nms(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep responses equal to the maximum of their (2r+1)^2 window (-inf
    outside the image), -inf elsewhere."""
    k = 2 * radius + 1
    lead = resp.shape[:-2]
    local_max = F.max_pool2d(resp.reshape(-1, 1, *resp.shape[-2:]), k, stride=1, padding=radius)
    local_max = local_max.reshape(*lead, *resp.shape[-2:])
    return torch.where(resp >= local_max, resp, float("-inf"))


def detect_features(
    image: torch.Tensor,
    max_features: int = 512,
    k: float = 0.05,
    nms_radius: int = 4,
    window: int = 5,
    border: int = 8,
    min_response_ratio: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top ``max_features`` Harris corners after NMS of (..., H, W) images.

    Returns (uv (..., F, 2) float32, response (..., F), valid (..., F) bool).
    Corners weaker than ``min_response_ratio`` times the strongest, or within
    ``border`` pixels of the edge, are invalid (padding slots)."""
    h, w = image.shape[-2:]
    resp = harris_response(image, k=k, window=window)
    nms = _nms(resp, nms_radius)
    v_idx = torch.arange(h, device=image.device)[:, None]
    u_idx = torch.arange(w, device=image.device)[None, :]
    interior = (v_idx >= border) & (v_idx < h - border) & (u_idx >= border) & (u_idx < w - border)
    nms = torch.where(interior, nms, float("-inf"))

    flat = nms.reshape(*nms.shape[:-2], h * w)
    top_vals, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :max_features], top_idx[..., :max_features]
    vv = top_idx // w
    uu = top_idx % w

    # subpixel: a 1-D parabola through the raw response along each axis
    # (integer corners carry a per-view quantization bias into the poses)
    resp_flat = resp.reshape(*resp.shape[:-2], h * w)

    def r_at(dv, du):
        idx = (vv + dv).clamp(0, h - 1) * w + (uu + du).clamp(0, w - 1)
        return torch.gather(resp_flat, -1, idx)

    def parab(center, minus, plus):
        denom = minus - 2.0 * center + plus
        ok = denom.abs() > 1e-12
        delta = torch.where(ok, 0.5 * (minus - plus) / torch.where(ok, denom, 1.0), 0.0)
        return delta.clamp(-0.5, 0.5)

    r0 = r_at(0, 0)
    du = parab(r0, r_at(0, -1), r_at(0, 1))
    dv = parab(r0, r_at(-1, 0), r_at(1, 0))
    uv = torch.stack([uu.to(torch.float32) + du, vv.to(torch.float32) + dv], dim=-1)
    max_resp = top_vals[..., :1].clamp_min(1e-12)
    valid = (top_vals > min_response_ratio * max_resp) & torch.isfinite(top_vals)
    return uv, top_vals, valid


def _bilinear_gather(image: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Edge-clipped bilinear samples of (..., H, W) images at (..., F, p, p)
    coordinates, in the reference's operation order."""
    h, w = image.shape[-2:]
    su, sv = torch.broadcast_tensors(su, sv)
    u0 = torch.floor(su)
    v0 = torch.floor(sv)
    fu, fv = su - u0, sv - v0
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)
    flat = image.reshape(*image.shape[:-2], 1, h * w)
    shape = su.shape

    def g(vi, ui):
        idx = (vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)).reshape(*shape[:-3], 1, -1)
        return torch.gather(flat, -1, idx).reshape(shape)

    return (g(v0, u0) * (1 - fu) * (1 - fv) + g(v0, u0 + 1) * fu * (1 - fv)
            + g(v0 + 1, u0) * (1 - fu) * fv + g(v0 + 1, u0 + 1) * fu * fv)


def describe_patches(image: torch.Tensor, uv: torch.Tensor, patch: int = 8,
                     stride: int = 2) -> torch.Tensor:
    """Mean/norm-normalized intensity patches around each corner: a (patch x
    patch) bilinear grid at ``stride``-pixel spacing, zero mean, unit norm.
    image (..., H, W), uv (..., F, 2) -> (..., F, patch * patch)."""
    half = (patch - 1) / 2.0
    offs = (torch.arange(patch, dtype=torch.float32, device=uv.device) - half) * stride
    su = uv[..., :, None, None, 0] + offs[None, :]
    sv = uv[..., :, None, None, 1] + offs[:, None]
    d = _bilinear_gather(image.to(torch.float32), su, sv).flatten(-2)
    d = d - torch.mean(d, dim=-1, keepdim=True)
    n = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return d / n.clamp_min(1e-6)


def extract_features(image: torch.Tensor, max_features: int = 512, k: float = 0.05,
                     nms_radius: int = 4, patch: int = 8, stride: int = 2) -> Features:
    """Detection and description in one call; (..., H, W) images batch."""
    uv, resp, valid = detect_features(image, max_features=max_features, k=k,
                                      nms_radius=nms_radius)
    desc = describe_patches(image, uv, patch=patch, stride=stride)
    return Features(uv=uv, response=resp, descriptor=desc, valid=valid)
