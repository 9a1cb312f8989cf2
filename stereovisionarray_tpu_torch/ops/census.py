"""Census transform + Hamming distance (twin of ``stereovisionarray_tpu/ops/census.py``).

Same bit layout as the reference: the (wh*ww - 1) comparison bits
``neighbor < center`` are packed little-endian, row-major over the window, into
``ceil(bits / 32)`` 32-bit planes. PyTorch has no unsigned 32-bit arithmetic
on every device, so each plane is held in an int64 tensor (values in
[0, 2**32)); the bit pattern equals the reference's uint32 planes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _edge_pad(image: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate the last two axes by (ph, pw) on each side."""
    h, w = image.shape[-2], image.shape[-1]
    rows = torch.arange(-ph, h + ph, device=image.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=image.device).clamp(0, w - 1)
    return image[..., rows, :][..., cols]


def census_transform(image: torch.Tensor, window: Tuple[int, int] = (7, 9)) -> torch.Tensor:
    """(..., H, W) intensities -> (..., H, W, P) int64 bit planes, P = ceil((wh*ww-1)/32).

    Out-of-bounds neighbours compare against the edge-padded image."""
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError(f"census window must be odd, got {window}")
    ph, pw = wh // 2, ww // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = _edge_pad(image, ph, pw)

    planes = []
    bit_idx = 0
    current = torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    for dy in range(-ph, ph + 1):
        for dx in range(-pw, pw + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = padded[..., dy + ph : dy + ph + h, dx + pw : dx + pw + w]
            current |= (neighbor < image).to(torch.int64) << (bit_idx % 32)
            bit_idx += 1
            if bit_idx % 32 == 0:
                planes.append(current)
                current = torch.zeros_like(current)
    if bit_idx % 32 != 0:
        planes.append(current)
    return torch.stack(planes, dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a value in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., P) census planes -> (...,) Hamming distance in `dtype`."""
    return popcount32(a ^ b).sum(dim=-1).to(dtype)
