"""Fused translation plane sweep with census cost: kernel K8 (twin of
``stereovisionarray_tpu/ops/sweep_pallas.py::plane_sweep_census_pallas``).

For every plane d and source s, the source is shifted by the uniform
subpixel translation ``shifts[d, s] = (su, sv)`` (bilinear, zero outside the
image), census-transformed with real shifted content as the neighbours of
border pixels, and compared with the edge-padded reference census by Hamming
distance; a source whose shifted pixel falls outside the image contributes
the ceiling ``patch^2 - 1``. The per-view costs are fused by

 - ``valid_mean=True``: the mean over in-view sources (``fusion="mean"``),
   the sum divided by the count;
 - ``topk=k`` (1 <= k < S): the mean of the k smallest costs
   (``fusion="topk_mean"`` with k below the view count), the sum times the
   float32 reciprocal of k;
 - otherwise: the ceiling-padded mean over all S sources (``topk_mean`` with
   k >= S), the sum times the float32 reciprocal of S.

These are the semantics of the reference's ``_fuse_views``; its many-view
Pallas kernel differs in one case (``sweep_pallas.py:356``: sentinel pad
views add the ceiling to the plain mean when S > 8 is not a multiple of 6),
which the port does not reproduce.

:func:`plane_sweep_census` launches ``csrc/plane_sweep.cu`` on CUDA tensors;
:func:`plane_sweep_census_plain` computes the same function in plain PyTorch
(the CPU and the tests use it). Both return (H, W, D) volumes, the layout the
SGM path scans read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend

__all__ = ["plane_sweep_census", "plane_sweep_census_plain"]

MAX_TOPK = 200  # top-k slots live in shared memory: k * 256 threads * 4 bytes
PLAIN_PLANE_CHUNK = 4  # planes per step of the plain twin: bounds its (planes, S, H, W) stacks


def reciprocal_f32(n: int) -> float:
    """float32 ``1/n``. The reference divides by a constant view or slot
    count, which XLA compiles into a product with this reciprocal; the port
    does the same, so its fused values equal the reference's bit for bit."""
    return float(np.float32(1.0) / np.float32(n))


def _validate(ref, src_images, shifts, patch, valid_mean, topk):
    if src_images.dim() != 3 or ref.shape != src_images.shape[1:]:
        raise ValueError(f"src_images must be (S, H, W) with (H, W) = ref.shape, got "
                         f"{tuple(src_images.shape)} and {tuple(ref.shape)}")
    if shifts.dim() != 3 or shifts.shape[1:] != (src_images.shape[0], 2):
        raise ValueError(f"shifts must be (D, S, 2), got {tuple(shifts.shape)}")
    if patch < 3 or patch % 2 == 0:
        raise ValueError(f"patch must be odd and >= 3, got {patch}")
    if topk is not None:
        if valid_mean:
            raise ValueError("valid_mean and topk are exclusive fusions")
        if not 1 <= topk < src_images.shape[0]:
            raise ValueError("topk must be in [1, n_views); use the mean for k >= n_views")


def _ref_bits(ref: torch.Tensor, M: int) -> torch.Tensor:
    """(patch^2 - 1, H, W) bool census bits of the reference, edge-clamped
    neighbours, in the census bit order (row-major, centre skipped)."""
    h, w = ref.shape
    rows = torch.arange(-M, h + M, device=ref.device).clamp(0, h - 1)
    cols = torch.arange(-M, w + M, device=ref.device).clamp(0, w - 1)
    padded = ref[rows][:, cols]
    return torch.stack([padded[M + dy: M + dy + h, M + dx: M + dx + w] < ref
                        for dy in range(-M, M + 1) for dx in range(-M, M + 1)
                        if (dy, dx) != (0, 0)])


def _sweep_chunk(src_images, ref_bits, shifts, patch, valid_mean, topk):
    """Fused cost and view count (DC, H, W) of a chunk of planes."""
    S, h, w = src_images.shape
    M = patch // 2
    dev = src_images.device
    su, sv = shifts[..., 0], shifts[..., 1]  # (DC, S)
    i0, j0 = torch.floor(su), torch.floor(sv)
    fu, fv = su - i0, sv - j0
    # zero-padded source window of every (plane, view): rows y + j0 and
    # columns x + i0 for y in [-M, H+M], x in [-M, W+M]
    rows = torch.arange(-M, h + M + 1, device=dev) + j0.to(torch.int64)[..., None]
    cols = torch.arange(-M, w + M + 1, device=dev) + i0.to(torch.int64)[..., None]
    s_idx = torch.arange(S, device=dev)[None, :, None, None]
    win = src_images[s_idx, rows.clamp(0, h - 1)[..., :, None], cols.clamp(0, w - 1)[..., None, :]]
    inb = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
    win = torch.where(inb, win, 0.0)
    fu4, fv4 = fu[..., None, None], fv[..., None, None]
    top = win[..., :-1, :-1] * (1.0 - fu4) + win[..., :-1, 1:] * fu4
    bot = win[..., 1:, :-1] * (1.0 - fu4) + win[..., 1:, 1:] * fu4
    warped = top * (1.0 - fv4) + bot * fv4  # (DC, S, H+2M, W+2M)

    center = warped[..., M: M + h, M: M + w]
    ham = torch.zeros(center.shape, dtype=torch.int32, device=dev)
    bit = 0
    for dy in range(-M, M + 1):
        for dx in range(-M, M + 1):
            if (dy, dx) == (0, 0):
                continue
            nb = warped[..., M + dy: M + dy + h, M + dx: M + dx + w]
            ham += (nb < center) != ref_bits[bit]
            bit += 1

    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    su2, sv2 = (i0 + fu)[..., None], (j0 + fv)[..., None]  # the reference kernel's float test
    ok_u = (u + su2 >= 0.0) & (u + su2 <= w - 1.0)  # (DC, S, W)
    ok_v = (v + sv2 >= 0.0) & (v + sv2 <= h - 1.0)  # (DC, S, H)
    ok = ok_v[..., :, None] & ok_u[..., None, :]
    nv = ok.sum(dim=1, dtype=torch.int32)
    cost = ham.to(torch.float32)
    ceiling = float(patch * patch - 1)
    if topk is not None:
        best = torch.topk(torch.where(ok, cost, ceiling), topk, dim=1, largest=False).values
        fused = best.sum(dim=1) * reciprocal_f32(topk)
    elif valid_mean:
        fused = torch.where(ok, cost, 0.0).sum(dim=1) / nv.clamp_min(1).to(torch.float32)
    else:
        fused = torch.where(ok, cost, ceiling).sum(dim=1) * reciprocal_f32(S)
    return fused, nv


def plane_sweep_census_plain(ref: torch.Tensor, src_images: torch.Tensor, shifts: torch.Tensor,
                             patch: int = 5, valid_mean: bool = False,
                             topk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K8: (fused (H, W, D) float32, nviews (H, W, D)
    int32)."""
    _validate(ref, src_images, shifts, patch, valid_mean, topk)
    src_images = src_images.to(torch.float32)
    bits = _ref_bits(ref.to(torch.float32), patch // 2)
    shifts = shifts.to(torch.float32)
    step = PLAIN_PLANE_CHUNK
    outs = [_sweep_chunk(src_images, bits, shifts[i: i + step], patch, valid_mean, topk)
            for i in range(0, shifts.shape[0], step)]
    fused = torch.cat([o[0] for o in outs]).permute(1, 2, 0).contiguous()
    nv = torch.cat([o[1] for o in outs]).permute(1, 2, 0).contiguous()
    return fused, nv


def plane_sweep_census(ref: torch.Tensor, src_images: torch.Tensor, shifts: torch.Tensor,
                       patch: int = 5, valid_mean: bool = False, topk: Optional[int] = None,
                       backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ref (H, W), src_images (S, H, W), shifts (D, S, 2) float32 ->
    (fused (H, W, D) float32, nviews (H, W, D) int32)."""
    if resolve_backend(ref, backend) != "cuda":
        return plane_sweep_census_plain(ref, src_images, shifts, patch, valid_mean, topk)
    _validate(ref, src_images, shifts, patch, valid_mean, topk)
    if topk is not None and topk > MAX_TOPK:
        raise ValueError(f"the CUDA sweep keeps at most {MAX_TOPK} top-k slots, got {topk}")
    S, h, w = src_images.shape
    D = shifts.shape[0]
    _native.check(ref, "ref", torch.float32, (h, w))
    _native.check(src_images, "src_images", torch.float32, (S, h, w))
    _native.check(shifts, "shifts", torch.float32, (D, S, 2))
    fused = torch.empty((h, w, D), dtype=torch.float32, device=ref.device)
    nviews = torch.empty((h, w, D), dtype=torch.int32, device=ref.device)
    mode = 2 if topk is not None else (1 if valid_mean else 0)
    _native.launch("svt_plane_sweep", ref.device, ref.data_ptr(), src_images.data_ptr(),
                   shifts.data_ptr(), fused.data_ptr(), nviews.data_ptr(), S, h, w, D, int(patch),
                   mode, int(topk or 0))
    plane_sweep_census.launches += 1
    return fused, nviews


plane_sweep_census.launches = 0
