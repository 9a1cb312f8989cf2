"""Plain PyTorch operations shared by the references: census, Hamming,
edge-adaptive P2, integer SGM, the extraction maps with the LR check, PKRN.

A frozen copy of the port's plain twins (``ops/census.py``, ``ops/sgm.py``,
``ops/extract_cuda.py``, ``ops/confidence.py`` of
``stereovisionarray_tpu_torch``), kept to the integer route the benchmark's
cells run. Floating-point expressions keep the twins' operations and their
order, so on the same device they give the same bits as the port's kernels,
which are bit-exact to those twins. Nothing here imports the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

BIG_INT = 16000  # integer sentinel at the d borders and past the right image edge
BIG_FLOAT = 1e9  # LR source left of the image
INVALID_DISPARITY = -1.0
# path (dy, dx) steps: down, up, left->right, right->left, then the diagonals
PATH_STEPS = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))


def edge_pad(image: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate the last two axes by (ph, pw) on each side."""
    h, w = image.shape[-2], image.shape[-1]
    rows = torch.arange(-ph, h + ph, device=image.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=image.device).clamp(0, w - 1)
    return image[..., rows, :][..., cols]


def census_transform(image: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, P) int64 planes of 32 bits ``neighbour <
    centre``, row-major over the window, centre skipped, edge-padded."""
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = edge_pad(image, ph, pw)
    planes = []
    bit = 0
    current = torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    for dy in range(-ph, ph + 1):
        for dx in range(-pw, pw + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[..., dy + ph: dy + ph + h, dx + pw: dx + pw + w]
            current |= (nb < image).to(torch.int64) << (bit % 32)
            bit += 1
            if bit % 32 == 0:
                planes.append(current)
                current = torch.zeros_like(current)
    if bit % 32:
        planes.append(current)
    return torch.stack(planes, dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P) census planes -> (...,) float32 Hamming distance."""
    return popcount32(a ^ b).sum(dim=-1).to(torch.float32)


def _edge_p2(image: torch.Tensor, axis: int, p2: float, p2_min: float,
             dtype: torch.dtype) -> torch.Tensor:
    """``max(P2 / (1 + 0.5 |grad|), p2_min)``, the gradient along `axis` (0
    at the first row or column), in float32, rounded half to even."""
    img = image.to(torch.float32)
    g = torch.diff(img, dim=axis, prepend=img.narrow(axis, 0, 1)).abs()
    p2_map = torch.maximum(torch.tensor(p2, dtype=torch.float32) / (1.0 + 0.5 * g),
                           torch.tensor(p2_min, dtype=torch.float32))
    return torch.round(p2_map).to(dtype)


def p2_maps(image: torch.Tensor, p2: int, p2_min: int, adaptive: bool,
            dtype: torch.dtype = torch.int16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p2_y, p2_x) integer penalty maps of an (H, W) image."""
    if adaptive:
        return _edge_p2(image, 0, p2, p2_min, dtype), _edge_p2(image, 1, p2, p2_min, dtype)
    const = torch.full(tuple(image.shape), p2, dtype=dtype, device=image.device)
    return const, const


def _step(prev: torch.Tensor, cost: torch.Tensor, p1: int, p2: torch.Tensor) -> torch.Tensor:
    """One step of the recurrence on an (N, D) int32 front; p2 is (N, 1)."""
    big = torch.full_like(prev[:, :1], BIG_INT)
    prev_min = prev.amin(dim=-1, keepdim=True)
    up = torch.cat([big, prev[:, :-1]], dim=-1)
    dn = torch.cat([prev[:, 1:], big], dim=-1)
    best = torch.minimum(torch.minimum(prev, prev_min + p2), torch.minimum(up, dn) + p1)
    return cost + (best - prev_min)


def _scan(vol: torch.Tensor, p2_map: torch.Tensor, p1: int, dy: int, dx: int,
          total: torch.Tensor) -> None:
    """Add one path's L (int32) into `total`. Lines along y carry a (W, D)
    front, shifted one column a row on the diagonals; lines along x a (H, D)
    front. The first pixel of every line starts with L = C."""
    h, w, _ = vol.shape
    if dy != 0:
        get = lambda t, i: t[i]  # noqa: E731
        order = range(h) if dy > 0 else range(h - 1, -1, -1)
        shift = dx
    else:
        get = lambda t, i: t[:, i]  # noqa: E731
        order = range(w) if dx > 0 else range(w - 1, -1, -1)
        shift = 0
    carry = None
    for i in order:
        cost = get(vol, i)
        if carry is None:
            carry = cost.clone()
        else:
            if shift:
                pad = torch.full_like(carry[:1], BIG_INT)
                carry = torch.cat([pad, carry[:-1]]) if shift > 0 else torch.cat([carry[1:], pad])
            carry = _step(carry, cost, p1, get(p2_map, i)[:, None])
        get(total, i).add_(carry)


def sgm_total(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1: int,
              num_paths: int, out_dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Sum of the 4 or 8 paths over an (H, W, D) integer volume, in int32,
    stored in `out_dtype` (int16 wraps the int32 sum)."""
    work = vol.to(torch.int32)
    maps = (p2_y.to(torch.int32), p2_x.to(torch.int32))
    total = torch.zeros_like(work)
    for dy, dx in PATH_STEPS[:num_paths]:
        _scan(work, maps[0] if dy != 0 else maps[1], int(p1), dy, dx, total)
    return total.to(out_dtype)


class Maps(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32 subpixel disparity, before masking
    cost: torch.Tensor  # (H, W) float32 winning cost
    valid: torch.Tensor  # (H, W) bool uniqueness (and LR) validity
    second: torch.Tensor  # (H, W) float32 best cost outside winner +-1


def _disparity(a: torch.Tensor, subpixel: bool):
    """WTA (ties to the smallest d) and the float32 parabola over (..., D)."""
    D = a.shape[-1]
    c_min, d_int = torch.min(a, dim=-1)
    d_c = d_int.clamp(1, D - 2)
    cm = torch.gather(a, -1, (d_c - 1)[..., None])[..., 0]
    cp = torch.gather(a, -1, (d_c + 1)[..., None])[..., 0]
    if not subpixel:
        return d_int.to(torch.float32), c_min, d_int
    cm, c0, cp = cm.to(torch.float32), c_min.to(torch.float32), cp.to(torch.float32)
    denom = cm - 2.0 * c0 + cp
    nonflat = denom.abs() > 1e-9
    safe = torch.where(nonflat, denom, 1.0)
    delta = torch.where(nonflat, (cm - cp) / (2.0 * safe), 0.0).clamp(-0.5, 0.5)
    interior = (d_int >= 1) & (d_int <= D - 2)
    disp = torch.where(interior, d_c.to(torch.float32) + delta, d_int.to(torch.float32))
    return disp, c_min, d_int


def extract_maps(total: torch.Tensor, subpixel: bool, uniqueness: float,
                 lr_max_diff: float) -> Maps:
    """The maps of an (H, W, D) integer total, with the left-right check in
    the validity when ``lr_max_diff > 0``."""
    h, w, D = total.shape
    a = total.to(torch.int32)
    disp, c_min, d_int = _disparity(a, subpixel)
    d_iota = torch.arange(D, device=a.device)
    near = (d_iota - d_int[..., None]).abs() <= 1
    second = torch.where(near, BIG_INT, a).amin(dim=-1).to(torch.float32)
    cost = c_min.to(torch.float32)
    valid = torch.ones((h, w), dtype=torch.bool, device=a.device)
    if uniqueness > 0.0:
        valid &= cost < uniqueness * second
    if lr_max_diff > 0:
        # right view: ar[y, x, d] = total[y, x + d, d], BIG past the right border
        src = torch.arange(w, device=a.device)[:, None] + d_iota[None, :]
        ar = torch.gather(a, 1, src.clamp(max=w - 1).expand(h, w, D))
        ar = torch.where(src < w, ar, BIG_INT)
        disp_r, _, _ = _disparity(ar, subpixel)
        dl_int = torch.round(disp).to(torch.int64).clamp(0, D - 1)
        col = torch.arange(w, device=a.device)[None, :] - dl_int
        at = torch.where(col >= 0, torch.gather(disp_r, 1, col.clamp(min=0)), BIG_FLOAT)
        valid = valid & ((disp - at).abs() <= lr_max_diff) & (at < BIG_FLOAT)
    return Maps(disp, cost, valid, second)


def pkrn_confidence(best: torch.Tensor, second: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, eps: float = 1e-3) -> torch.Tensor:
    """``1 - (c1 + eps) / (c2 + eps)``, 0 where `valid` is False."""
    c1 = best.to(torch.float32).clamp_min(0.0)
    c2 = torch.maximum(second.to(torch.float32), c1)
    conf = 1.0 - (c1 + eps) / (c2 + eps)
    if valid is not None:
        conf = torch.where(valid, conf, 0.0)
    return conf
