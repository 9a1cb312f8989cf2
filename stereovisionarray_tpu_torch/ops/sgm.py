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
and int16 costs). Float volumes compute each path as the reference's float
recurrence does; :func:`aggregate_paths` sums them as its XLA scans do, and
:func:`aggregate_paths_float` in the order (fused multiply-adds included) of
one of its Pallas routes (``ORDERS``). The CUDA kernels behind both are in
``ops/sgm_cuda.py``. :func:`sgm_aggregate_reference` is the reference's
per-pixel numpy oracle, for tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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
    rounded half to even into an integer `dtype`. The two constants stay
    0-dim CPU tensors: a copy of each to the card would wait for the stream."""
    img = image.to(torch.float32)
    g = torch.diff(img, dim=axis, prepend=img.narrow(axis, 0, 1)).abs()
    p2_map = torch.maximum(
        torch.tensor(p2, dtype=torch.float32) / (1.0 + 0.5 * g),
        torch.tensor(p2_min, dtype=torch.float32),
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


def _scan_path(vol, p2_map, p1, dy: int, dx: int, out, step, big, accumulate: bool) -> None:
    """One path's L, added to `out` in place (`accumulate`) or written into
    it. vol/out: (H, W, D); the lines run along y (dy != 0; diagonals shift
    the (W, D) front by dx per row) or along x (dy == 0; front (H, D))."""
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
        if accumulate:
            get(out, i).add_(carry)
        else:
            get(out, i).copy_(carry)


def aggregate_paths(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor,
                    p1, num_paths: int = 8) -> torch.Tensor:
    """Sum of the 4 or 8 SGM paths over an (H, W, D) cost volume.

    Integer volumes: int32 arithmetic, result in :func:`sum_dtype`, bit-exact
    to the reference's Pallas sweeps. Float volumes: path sums added in path
    order, as the reference's XLA ``sgm_aggregate_paths`` adds them (the
    Pallas routes' orders are :func:`aggregate_paths_float`)."""
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    integer = not vol.dtype.is_floating_point
    work, maps, p1, step, big = _scan_setup(vol, p2_y, p2_x, p1)
    total = torch.zeros_like(work)
    for dy, dx in PATH_STEPS[:num_paths]:
        _scan_path(work, maps[0] if dy != 0 else maps[1], p1, dy, dx, total, step, big, True)
    return total.to(sum_dtype(vol.dtype)) if integer else total


def _scan_setup(vol, p2_y, p2_x, p1):
    """(work volume, (p2_y, p2_x), p1, step, BIG) in the compute dtype."""
    if not vol.dtype.is_floating_point:
        return (vol.to(torch.int32), (p2_y.to(torch.int32), p2_x.to(torch.int32)), int(p1),
                _step_int, BIG_INT)
    return (vol, (p2_y.to(vol.dtype), p2_x.to(vol.dtype)),
            torch.tensor(p1, dtype=vol.dtype), _step_float, BIG_FLOAT)  # 0-dim on the CPU: no wait


# ---------------------------------------------------------------------------
# Float sums in the orders of the reference's Pallas routes
# ---------------------------------------------------------------------------

# sweep -> path ids; a sweep is the reference's unit of path parallelism
# (sgm_pallas.py SWEEP_PATHS_8 / SWEEP_PATHS_4): down = axis, diag+1, diag-1
SWEEP_PATHS_8 = {"down": (0, 4, 5), "up": (1, 6, 7), "lr": (2,), "rl": (3,)}
SWEEP_PATHS_4 = {"down": (0,), "up": (1,), "lr": (2,), "rl": (3,)}
ALL_SWEEPS = ("down", "up", "lr", "rl")
# float summation orders, named after the reference function that sums so;
# a sweep's group is (axis + diag+1) + diag-1:
#   k7   sgm_aggregate_pallas_sweeps: (down + up) + (lr + rl)
#   wdh  sgm_extract_fused_wdh:       ((down + up) + lr) + rl
#   k10  sgm_aggregate_pallas:        (down + up) + (lr + rl)
#   k12  sgm_extract_fused_hdw:       ((lr + rl) + down) + up
# With 8 paths k7 and wdh add the up group's first row (y = H-1, where each
# of its three paths is L = C) into down as one fused multiply-add,
# fma(3, C, down): the reference's kernel writes `acc + 3 * row` and XLA
# contracts it. k12 does the same twice: at the down group's first row
# (y = 0) onto lr + rl, and at the up group's (y = H-1) onto the rest. k10
# sums outside its kernels and rounds each add.
ORDERS = ("k7", "wdh", "k10", "k12")


def sweep_paths(num_paths: int) -> dict:
    if num_paths not in (4, 8):
        raise ValueError("num_paths must be 4 or 8")
    return SWEEP_PATHS_8 if num_paths == 8 else SWEEP_PATHS_4


def check_sweeps(sweeps, order: str) -> tuple:
    """The sweep subset in canonical order; only ``k7`` sums a subset."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected one of {ORDERS}")
    unknown = set(sweeps) - set(ALL_SWEEPS)
    if unknown or not sweeps:
        raise ValueError(f"sweeps must be a non-empty subset of {ALL_SWEEPS}, got {sweeps}")
    sweeps = tuple(s for s in ALL_SWEEPS if s in sweeps)
    if order != "k7" and sweeps != ALL_SWEEPS:
        raise ValueError(f"order {order!r} sums all four sweeps")
    return sweeps


def path_partials(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                  path_ids) -> dict:
    """path id -> that path's (H, W, D) float L volume (``_step_float``, the
    reference's float recurrence bit for bit)."""
    work, maps, p1, step, big = _scan_setup(vol, p2_y, p2_x, p1)
    parts = {}
    for pid in path_ids:
        dy, dx = PATH_STEPS[pid]
        parts[pid] = torch.empty_like(work)
        _scan_path(work, maps[0] if dy != 0 else maps[1], p1, dy, dx, parts[pid], step, big,
                   False)
    return parts


def fmaf(a, b, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, acc)``: a * b + acc rounded once. The product of
    two floats is exact in double and the double sum's own rounding error is
    recovered (TwoSum); it decides the one case where rounding the double sum
    to float32 could go the wrong way, a sum that lands exactly halfway
    between two floats. `a` may be a Python number that is a float32."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    x, y = acc.double(), a * b.double()
    s = x + y
    yy = s - x
    err = (x - (s - yy)) + (y - yy)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    go_up = (s == (r.double() + up.double()) * 0.5) & (err > 0)
    go_dn = (s == (r.double() + dn.double()) * 0.5) & (err < 0)
    return torch.where(go_up, up, torch.where(go_dn, dn, r))


def fma3(c: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(3, c, acc)``: 3c + acc rounded once."""
    return fmaf(3.0, c, acc)


def _plus(a, b):
    return b if a is None else (a if b is None else a + b)


def combine_partials(parts: dict, num_paths: int, sweeps=ALL_SWEEPS,
                     order: str = "k7") -> torch.Tensor:
    """Sum per-path float partials (``path_partials``) over `sweeps` (checked
    by the caller, :func:`check_sweeps`) in a route's order."""
    groups = sweep_paths(num_paths)
    g = {}
    for s in sweeps:
        ids = groups[s]
        g[s] = parts[ids[0]]
        for pid in ids[1:]:
            g[s] = g[s] + parts[pid]
    fused = num_paths == 8 and order != "k10"
    if order == "k12":
        horiz = g["lr"] + g["rl"]
        acc = horiz + g["down"]
        if fused:
            acc[0] = fma3(parts[0][0], horiz[0])
        total = acc + g["up"]
        if fused:
            total[-1] = fma3(parts[1][-1], acc[-1])
        return total
    vert = _plus(g.get("down"), g.get("up"))
    if fused and "down" in g and "up" in g:
        vert[-1] = fma3(parts[1][-1], g["down"][-1])
    if order == "wdh":
        return (vert + g["lr"]) + g["rl"]
    return _plus(vert, _plus(g.get("lr"), g.get("rl")))


def aggregate_paths_float(vol: torch.Tensor, p2_y: torch.Tensor, p2_x: torch.Tensor, p1,
                          num_paths: int = 8, sweeps=ALL_SWEEPS,
                          order: str = "k7") -> torch.Tensor:
    """Plain twin of the float aggregation kernel K7: the paths of `sweeps`
    over an (H, W, D) float32 volume, summed in `order` (see ``ORDERS``)."""
    sweeps = check_sweeps(sweeps, order)
    groups = sweep_paths(num_paths)
    ids = [pid for s in sweeps for pid in groups[s]]
    return combine_partials(path_partials(vol, p2_y, p2_x, p1, ids), num_paths, sweeps, order)


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


def sgm_aggregate_reference(vol, p1: float, p2: float, num_paths: int = 8) -> np.ndarray:
    """The reference's slow oracle: the dynamic program pixel by pixel in
    float64 numpy, constant P2. `vol` is an (H, W, D) tensor (on any device)
    or array; returns the (H, W, D) float64 path sum."""
    if isinstance(vol, torch.Tensor):
        vol = vol.detach().cpu().numpy()
    vol = np.asarray(vol, dtype=np.float64)
    h, w, D = vol.shape
    dirs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if num_paths == 8:
        dirs += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    total = np.zeros_like(vol)
    for dy, dx in dirs:
        L = np.zeros_like(vol)
        ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
        xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < h and 0 <= px < w:
                    prev = L[py, px]
                    pmin = prev.min()
                    cand = np.minimum(prev, pmin + p2)
                    cand = np.minimum(cand, np.concatenate([[prev[0] + p1 + 1.0], prev[:-1] + p1]))
                    cand = np.minimum(cand, np.concatenate([prev[1:] + p1, [prev[-1] + p1 + 1.0]]))
                    L[y, x] = vol[y, x] + cand - pmin
                else:
                    L[y, x] = vol[y, x]
        total += L
    return total
