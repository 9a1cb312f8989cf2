"""Landmark-free subject detection: a moment-based foreground ellipse (twin
of ``stereovisionarray_tpu/roi/detect.py``).

Box smoothing, an Otsu threshold over a 64-bin histogram, the soft
foreground weight's centroid and second moments, and the ellipse of their
principal axes with the reference's vertical stretch. Every step runs on the
image's device; nothing is copied to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovisionarray_tpu_torch.ops.sweep_cuda import reciprocal_f32

__all__ = ["EllipseROI", "detect_face_ellipse"]


class EllipseROI(NamedTuple):
    center: torch.Tensor  # (2,) (u, v)
    axes: torch.Tensor  # (2,) semi-axes
    angle: torch.Tensor  # radians
    found: torch.Tensor  # bool: enough foreground support


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean with edge padding, as cumulative sums (the reference's
    division by k is its compiled product with the float32 reciprocal)."""
    p = k // 2
    inv_k = reciprocal_f32(k)

    def along(a, dim):
        n = a.shape[dim]
        idx = torch.arange(-p - 1, n + p, device=a.device).clamp(0, n - 1)
        c = torch.cumsum(a.index_select(dim, idx), dim=dim)
        return (c.narrow(dim, k, n) - c.narrow(dim, 0, n)) * inv_k

    return along(along(x, -1), -2)


def _otsu_threshold(image: torch.Tensor, bins: int = 64) -> torch.Tensor:
    """Otsu's threshold over a fixed-bin histogram: the bin centre of the
    first maximum of the between-class variance."""
    lo, hi = image.min(), image.max()
    span = torch.clamp(hi - lo, min=1e-6)
    idx = ((image - lo) / span * bins).to(torch.int32).clamp(0, bins - 1).reshape(-1)
    # counts by a scatter-add of ones: exact below 2**24 a bin, and, unlike
    # torch.bincount on a CUDA tensor, no read of the largest index on the host
    hist = torch.zeros(bins, dtype=torch.float32, device=image.device).scatter_add_(
        0, idx.to(torch.int64), torch.ones_like(idx, dtype=torch.float32))
    p = hist / torch.clamp(hist.sum(), min=1.0)
    centers = lo + (torch.arange(bins, dtype=torch.float32, device=image.device) + 0.5) / bins * span
    w0 = torch.cumsum(p, 0)
    mu_t = (p * centers).sum()
    mu0 = torch.cumsum(p * centers, 0)
    w1 = 1.0 - w0
    denom = torch.clamp(w0 * w1, min=1e-9)
    sigma_b = (mu_t * w0 - mu0) ** 2 / denom
    return centers.index_select(0, torch.argmax(sigma_b).reshape(1))[0]  # no host read


def detect_face_ellipse(image: torch.Tensor, smooth: int = 9, height_scale: float = 1.7,
                        min_fraction: float = 0.01, invert: bool = False) -> EllipseROI:
    """The dominant foreground blob of an (H, W) grayscale image as an
    ellipse ROI. invert=True when the subject is darker than the background;
    height_scale is the reference's 1.7x vertical stretch."""
    img = _box(image.to(torch.float32), smooth)
    img = -img if invert else img
    thr = _otsu_threshold(img)
    wgt = torch.clamp(img - thr, min=0.0)  # soft foreground weight

    h, w = img.shape
    v = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    total = wgt.sum()
    total_safe = torch.clamp(total, min=1e-6)
    cu = (wgt * u).sum() / total_safe
    cv = (wgt * v).sum() / total_safe
    duu = (wgt * (u - cu) ** 2).sum() / total_safe
    dvv = (wgt * (v - cv) ** 2).sum() / total_safe
    duv = (wgt * (u - cu) * (v - cv)).sum() / total_safe

    # principal axes of the weight distribution
    tr = duu + dvv
    det = duu * dvv - duv * duv
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    lam1, lam2 = tr / 2.0 + disc, tr / 2.0 - disc
    angle = 0.5 * torch.atan2(2.0 * duv, duu - dvv)
    # 2-sigma ellipse, vertically stretched like the reference's face oval
    a = 2.0 * torch.sqrt(torch.clamp(lam1, min=1.0))
    b = 2.0 * torch.sqrt(torch.clamp(lam2, min=1.0))
    axes = torch.stack([a, b * (height_scale / 1.7)])
    found = total > min_fraction * h * w * torch.clamp(wgt.max(), min=1e-6)
    return EllipseROI(center=torch.stack([cu, cv]), axes=axes, angle=angle, found=found)
