"""Semi-global matching aggregation, plain PyTorch (twin of
``stereovisionarray_tpu/ops/sgm.py`` and of the integer arithmetic of
``stereovisionarray_tpu/ops/sgm_pallas.py``).

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               min(L_r(p-r, d-1), L_r(p-r, d+1)) + P1,
                               min_d' L_r(p-r, d') + P2 ) - min_d' L_r(p-r, d')

over 4 paths (down, up, left->right, right->left) or 8 (+ the diagonals
down-right, down-left, up-right, up-left). Every path is a set of independent
1-D lines; the first pixel of a line starts fresh with L = C. P2 is the map
value at the pixel being updated: ``p2_y`` on the vertical and diagonal paths,
``p2_x`` on the horizontal ones.

Integer volumes compute in int32 with the reference's BIG = 16000 sentinel at
the d borders, and store the path sum in :func:`sum_dtype` (int16 for int8
and int16 costs). Float volumes compute as the reference's XLA scans do. The
CUDA kernel for the integer paths is ``ops/sgm_cuda.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BIG_INT = 16000  # int16 sentinel of the reference: survives +P1/+P2 without overflow
BIG_FLOAT = 1e9  # float fresh-start carry of the reference's XLA scans

# path id -> (dy, dx) step; ids as in the reference's ops/sgm.py
PATH_STEPS = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Storage dtype of path sums: int8 costs (max 70) sum in int16 (8-path
    total ~1330); other dtypes sum in themselves."""
    return torch.int16 if dtype == torch.int8 else dtype


def _edge_p2(image: torch.Tensor, axis: int, p2: float, p2_min: float,
             dtype: torch.dtype) -> torch.Tensor:
    """Adaptive P2 per pixel: ``max(P2 / (1 + 0.5 |grad|), p2_min)`` with the
    gradient along `axis` (0 at the first row/column), computed in float32 and
    rounded half to even into an integer `dtype`."""
    img = image.to(torch.float32)
    g = torch.diff(img, dim=axis, prepend=img.narrow(axis, 0, 1)).abs()
    p2_map = torch.maximum(
        torch.tensor(p2, dtype=torch.float32, device=img.device) / (1.0 + 0.5 * g),
        torch.tensor(p2_min, dtype=torch.float32, device=img.device),
    )
    if not dtype.is_floating_point:
        return torch.round(p2_map).to(dtype)
    return p2_map.to(dtype)


def p2_maps(shape: Tuple[int, int], p2: float, dtype: torch.dtype, device,
            image: Optional[torch.Tensor] = None, adaptive_p2: bool = False,
            p2_min: float = 24.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p2_y, p2_x), each (H, W) in `dtype`: edge-adaptive from `image` when
    `adaptive_p2`, else constant."""
    if adaptive_p2 and image is not None:
        return _edge_p2(image, 0, p2, p2_min, dtype), _edge_p2(image, 1, p2, p2_min, dtype)
    const = torch.full(shape, p2, dtype=dtype, device=device)
    return const, const


def _step_int(prev, cost, p1: int, p2):
    """One integer step on an (N, D) int32 front; p2 (N, 1) int32."""
    big = torch.full_like(prev[:, :1], BIG_INT)
    prev_min = prev.amin(dim=-1, keepdim=True)
    up = torch.cat([big, prev[:, :-1]], dim=-1)
    dn = torch.cat([prev[:, 1:], big], dim=-1)
    best = torch.minimum(torch.minimum(prev, prev_min + p2), torch.minimum(up, dn) + p1)
    return cost + (best - prev_min)


def _step_float(prev, cost, p1, p2):
    """One float step, the reference's ``ops/sgm._step`` operation for operation."""
    prev_min = prev.amin(dim=-1, keepdim=True)
    up = torch.cat([prev[:, :1] + p1 + 1.0, prev[:, :-1] + p1], dim=-1)
    dn = torch.cat([prev[:, 1:] + p1, prev[:, -1:] + p1 + 1.0], dim=-1)
    best = torch.minimum(torch.minimum(prev, prev_min + p2), torch.minimum(up, dn))
    return cost + (best - prev_min)


def _accumulate_path(vol, p2_map, p1, dy: int, dx: int, total, step, big) -> None:
    """Add one path's L to `total` in place. vol/total: (H, W, D); the lines
    run along y (dy != 0; diagonals shift the (W, D) front by dx per row) or
    along x (dy == 0; front (H, D))."""
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
        if carry is None:  # first pixel of every line: L = C
            carry = cost.clone()
        else:
            if shift:  # diagonal: the front moves one column; the entering column starts fresh
                pad = torch.full_like(carry[:1], big)
                carry = (torch.cat([pad, carry[:-1]]) if shift > 0
                         else torch.cat([carry[1:], pad]))
            carry = step(carry, cost, p1, get(p2_map, i)[:, None])
        get(total, i).add_(carry)


def aggregate_paths(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor,
                    p1, num_paths: int = 8) -> torch.Tensor:
    """Sum of the 4 or 8 SGM paths over an (H, W, D) cost volume.

    Integer volumes: int32 arithmetic, result in :func:`sum_dtype`, bit-exact
    to the reference's Pallas sweeps. Float volumes: path sums added in path
    order, as the reference's ``sgm_aggregate_paths`` adds them."""
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    integer = not vol.dtype.is_floating_point
    if integer:
        work = vol.to(torch.int32)
        maps = (p2_y.to(torch.int32), p2_x.to(torch.int32))
        step, big, p1 = _step_int, BIG_INT, int(p1)
    else:
        work = vol
        maps = (p2_y.to(vol.dtype), p2_x.to(vol.dtype))
        step, big = _step_float, BIG_FLOAT
        p1 = torch.tensor(p1, dtype=vol.dtype, device=vol.device)
    total = torch.zeros_like(work)
    for dy, dx in PATH_STEPS[:num_paths]:
        _accumulate_path(work, maps[0] if dy != 0 else maps[1], p1, dy, dx, total, step, big)
    return total.to(sum_dtype(vol.dtype)) if integer else total


def sgm_aggregate(
    vol: torch.Tensor,
    p1: float = 8.0,
    p2: float = 96.0,
    num_paths: int = 8,
    image: Optional[torch.Tensor] = None,
    adaptive_p2: bool = False,
    p2_min: float = 24.0,
) -> torch.Tensor:
    """Aggregate an (H, W, D) cost volume over 4 or 8 SGM paths (plain
    PyTorch). Integer volumes take penalties already in cost units (scaled by
    the cost dtype's fixed-point scale, see ``models/two_view.scaled_penalties``)."""
    h, w, _ = vol.shape
    p2_y, p2_x = p2_maps((h, w), p2, sum_dtype(vol.dtype), vol.device, image,
                         adaptive_p2, p2_min)
    return aggregate_paths(vol, p2_y, p2_x, p1, num_paths)
