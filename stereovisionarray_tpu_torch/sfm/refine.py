"""Lucas-Kanade subpixel refinement of matched positions (twin of
``stereovisionarray_tpu/sfm/refine.py``).

Each matched patch is aligned photometrically against its reference patch: a
2x2 normal-equation solve per feature and iteration, written out in closed
form and batched over features and views.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereovisionarray_tpu_torch.sfm.features import _bilinear_gather

__all__ = ["lk_refine"]


def _sample_patches(image: torch.Tensor, uv: torch.Tensor, patch: int):
    """Bilinear (..., F, p, p) patches and central-difference gradients at
    uv (..., F, 2) of (..., H, W) images: (P, gx, gy)."""
    half = (patch - 1) / 2.0
    offs = torch.arange(patch, dtype=torch.float32, device=uv.device) - half
    su, sv = torch.broadcast_tensors(uv[..., :, None, None, 0] + offs[None, :],
                                     uv[..., :, None, None, 1] + offs[:, None])
    p = _bilinear_gather(image, su, sv)
    gx = 0.5 * (_bilinear_gather(image, su + 1.0, sv) - _bilinear_gather(image, su - 1.0, sv))
    gy = 0.5 * (_bilinear_gather(image, su, sv + 1.0) - _bilinear_gather(image, su, sv - 1.0))
    return p, gx, gy


def lk_refine(ref_image: torch.Tensor, ref_uv: torch.Tensor, image: torch.Tensor,
              uv: torch.Tensor, patch: int = 11, iterations: int = 5, max_step: float = 1.0,
              max_total: float = 3.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine ``uv`` (..., F, 2) in ``image`` (..., H, W) so each local patch
    aligns with the patch at ``ref_uv`` (F, 2) in ``ref_image`` (H, W).

    Zero-mean patches absorb brightness differences between views. Steps are
    clamped to ``max_step`` px an iteration and the total correction to
    ``max_total`` px (past it the match was wrong: the input position is
    kept and ``converged`` is False). Returns (uv, converged)."""
    tpl, _, _ = _sample_patches(ref_image, ref_uv, patch)
    tpl = tpl - torch.mean(tpl, dim=(-2, -1), keepdim=True)
    cur = uv
    for _ in range(iterations):
        p, gx, gy = _sample_patches(image, cur, patch)
        p = p - torch.mean(p, dim=(-2, -1), keepdim=True)
        e = tpl - p
        a11 = torch.sum(gx * gx, dim=(-2, -1))
        a12 = torch.sum(gx * gy, dim=(-2, -1))
        a22 = torch.sum(gy * gy, dim=(-2, -1))
        b1 = torch.sum(gx * e, dim=(-2, -1))
        b2 = torch.sum(gy * e, dim=(-2, -1))
        det = a11 * a22 - a12 * a12
        ok = det.abs() > 1e-9
        det_safe = torch.where(ok, det, 1e-9)
        step = torch.stack([(a22 * b1 - a12 * b2) / det_safe,
                            (-a12 * b1 + a11 * b2) / det_safe], dim=-1)
        cur = cur + torch.where(ok[..., None], step.clamp(-max_step, max_step), 0.0)
    converged = torch.sqrt(torch.sum((cur - uv) ** 2, dim=-1)) <= max_total
    return torch.where(converged[..., None], cur, uv), converged
