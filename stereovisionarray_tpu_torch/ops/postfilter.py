"""Disparity post-filters: 3x3 median, speckle suppression, hole filling (twin
of ``stereovisionarray_tpu/ops/postfilter.py``).

The reference has no Pallas kernel here; its filters are chains of shifted
copies. The port computes the same functions with few launches on either
device: every window is one stacked view of an edge-replicated pad
(``Tensor.unfold``), so a filter is a handful of whole-image operations
rather than one shift/compare/add per tap. All three are bit-exact to the
reference: the median is a member of its nine values, the speckle support is
a small integer count, and the hole fill copies values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stereovisionarray_tpu_torch.ops.wta import INVALID_DISPARITY

__all__ = ["fill_holes", "median3x3", "shifted", "speckle_filter"]


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices ``clamp(i, 0, n - 1)`` for i in [lo, hi)."""
    return torch.arange(lo, hi, device=device).clamp(0, n - 1)


def shifted(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicated shift of the trailing (H, W) axes:
    ``out[y, x] = x[clamp(y - dy), clamp(x - dx)]``."""
    h, w = x.shape[-2:]
    rows = _edge_index(h, -dy, h - dy, x.device)
    cols = _edge_index(w, -dx, w - dx, x.device)
    return x[..., rows, :][..., cols]


def _windows(x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W, 2r+1, 2r+1) view of every (2r+1)^2 window of the edge-replicated
    (H, W) map: ``[y, x, i, j] = x[clamp(y + i - r), clamp(x + j - r)]``."""
    h, w = x.shape
    padded = x[_edge_index(h, -r, h + r, x.device)][:, _edge_index(w, -r, w + r, x.device)]
    return padded.unfold(0, 2 * r + 1, 1).unfold(1, 2 * r + 1, 1)


def median3x3(disp: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 median of a disparity map. Invalid neighbours contribute the
    centre's value instead; invalid centres keep their value."""
    src = disp if valid is None else torch.where(valid, disp, 0.0)
    vals = _windows(src, 1)
    if valid is not None:
        vals = torch.where(_windows(valid, 1), vals, src[..., None, None])
    med = vals.reshape(*src.shape, 9).median(dim=-1).values
    return med if valid is None else torch.where(valid, med, disp)


def speckle_filter(disp: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   max_diff: float = 1.0, window: int = 9,
                   min_support: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep a pixel where at least `min_support` valid pixels of its
    `window` x `window` edge-replicated neighbourhood (itself included) lie
    within `max_diff` of its disparity. Returns (disp with INVALID_DISPARITY
    where suppressed, keep)."""
    v = valid if valid is not None else disp >= 0
    r = window // 2
    near = (disp[..., None, None] - _windows(disp, r)).abs() <= max_diff
    support = (near & _windows(v, r)).sum(dim=(-2, -1))
    keep = v & (support >= min_support)
    return torch.where(keep, disp, INVALID_DISPARITY), keep


def _nearest_left(disp: torch.Tensor, valid: torch.Tensor, reach: int):
    """For each pixel of the (..., W) rows, the value of the nearest valid
    pixel at or left of it within `reach` columns, and whether there is one."""
    w = disp.shape[-1]
    col = torch.arange(w, device=disp.device)
    last = torch.where(valid, col, -1).cummax(dim=-1).values
    has = (last >= 0) & (col - last <= reach)
    return disp.gather(-1, last.clamp_min(0)), has


def fill_holes(disp: torch.Tensor, valid: Optional[torch.Tensor] = None,
               max_span: Optional[int] = None,
               take: str = "min") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill invalid pixels from the nearest valid pixels of their row: the
    smaller (``take="min"``, disparity maps: the background) or larger
    (``"max"``, plane-index maps whose index grows with depth) of the two
    sides where both exist, else the one that exists. Returns (filled,
    valid | filled).

    The reference finds each side's nearest valid pixel by log-doubling
    shifts (steps 1, 2, 4, ... while below `max_span`), which reaches
    ``2^m - 1`` columns after its m steps; the port finds the same pixel with
    one running maximum of valid column indices per side, both sides in one
    stacked pass, and applies the same reach."""
    if take not in ("min", "max"):
        raise ValueError(f"take must be 'min' or 'max', got {take!r}")
    v = valid if valid is not None else disp >= 0
    w = disp.shape[-1]
    span = min(int(max_span) if max_span is not None else w, w)
    steps = max(span - 1, 0).bit_length()  # the reference's doubling steps
    reach = (1 << steps) - 1
    both_d = torch.stack([disp, disp.flip(-1)])
    both_v = torch.stack([v, v.flip(-1)])
    vals, has = _nearest_left(both_d, both_v, reach)
    lval, rval = vals[0], vals[1].flip(-1)
    lhas, rhas = has[0], has[1].flip(-1)
    pick = torch.minimum if take == "min" else torch.maximum
    fill = torch.where(lhas & rhas, pick(lval, rval), torch.where(lhas, lval, rval))
    any_side = lhas | rhas
    out = torch.where(v, disp, torch.where(any_side, fill, INVALID_DISPARITY))
    return out, v | any_side
