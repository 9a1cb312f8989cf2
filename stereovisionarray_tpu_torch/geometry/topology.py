"""Camera-array pair topologies (numpy copy of
``stereovisionarray_tpu/geometry/topology.py``).

Host-side, shape-determining metadata: (P, 2) index arrays of
(reference_cam, source_cam) pairs over a rows x cols camera grid. The
reference module is numpy-only too, but its package ``__init__`` imports JAX,
so the port keeps its own copy.
"""

from __future__ import annotations

import enum
from typing import List, Tuple

import numpy as np

__all__ = ["PairTopology", "camera_pairs", "cross_pairs_around", "grid_positions", "pair_groups"]


class PairTopology(enum.Enum):
    """Pair selections of the reference's ``enum pairType``."""

    TO_CENTER = "to_center"
    TO_CENTER_SMALL = "to_center_small"
    MID_LEFT = "mid_left"
    MID_TOP = "mid_top"
    LINE_HORIZONTAL = "line_horizontal"
    LINE_VERTICAL = "line_vertical"
    CROSS = "cross"
    JUMP_CROSS = "jump_cross"

    @classmethod
    def _missing_(cls, value):
        # enum names and any case ("CROSS", "Cross") are accepted
        if isinstance(value, str):
            low = value.lower()
            for member in cls:
                if member.value == low:
                    return member
        return None


def _grid_center(rows: int, cols: int) -> int:
    return (rows // 2) * cols + (cols // 2)


def _in_grid(r: int, c: int, rows: int, cols: int) -> bool:
    return 0 <= r < rows and 0 <= c < cols


def cross_pairs_around(cam: int, rows: int, cols: int, step: int = 1) -> np.ndarray:
    """(ref, src) pairs between `cam` and its 4-neighbourhood at distance
    `step` (left, right, up, down); off-grid neighbours are dropped."""
    r, c = divmod(cam, cols)
    out = []
    for dr, dc in ((0, -step), (0, step), (-step, 0), (step, 0)):
        if _in_grid(r + dr, c + dc, rows, cols):
            out.append((cam, (r + dr) * cols + (c + dc)))
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def camera_pairs(topology, rows: int = 5, cols: int = 5, center: int | None = None) -> np.ndarray:
    """The (P, 2) pair list of a topology over a rows x cols grid; every pair
    is (center_cam, other_cam)."""
    if center is None:
        center = _grid_center(rows, cols)
    r0, c0 = divmod(center, cols)
    n = rows * cols
    t = PairTopology(topology)

    if t == PairTopology.TO_CENTER:
        pairs = [(center, i) for i in range(n) if i != center]
    elif t == PairTopology.TO_CENTER_SMALL:
        pairs = [(center, (r0 + dr) * cols + (c0 + dc))
                 for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                 if (dr, dc) != (0, 0) and _in_grid(r0 + dr, c0 + dc, rows, cols)]
    elif t == PairTopology.MID_LEFT:
        pairs = [(center, center - 1)] if c0 > 0 else []
    elif t == PairTopology.MID_TOP:
        pairs = [(center, center - cols)] if r0 > 0 else []
    elif t == PairTopology.LINE_HORIZONTAL:
        pairs = [(center, r0 * cols + c) for c in range(cols) if c != c0]
    elif t == PairTopology.LINE_VERTICAL:
        pairs = [(center, r * cols + c0) for r in range(rows) if r != r0]
    elif t == PairTopology.CROSS:
        return cross_pairs_around(center, rows, cols, step=1)
    else:  # JUMP_CROSS
        return cross_pairs_around(center, rows, cols, step=2)
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def pair_groups(group_type: str, rows: int = 5, cols: int = 5) -> List[np.ndarray]:
    """Groups of pair lists, the original program's ``getGroups("CHESS")``:
    the CROSS neighbourhood of every even camera index, each a (P_i, 2)
    array (empty neighbourhoods left out)."""
    if group_type.upper() != "CHESS":
        raise ValueError(f"unknown group type {group_type!r}")
    groups = []
    for cam in range(0, rows * cols, 2):
        g = cross_pairs_around(cam, rows, cols, step=1)
        if len(g):
            groups.append(g)
    return groups


def grid_positions(rows: int, cols: int, spacing: float,
                   origin: Tuple[float, float] = (0.0, 0.0), z: float = 0.0) -> np.ndarray:
    """(N, 3) float32 camera centres of a planar grid, row-major."""
    ys, xs = np.mgrid[0:rows, 0:cols].astype(np.float64)
    pos = np.stack(
        [origin[0] + xs * spacing, origin[1] + ys * spacing, np.full_like(xs, z)], axis=-1
    )
    return pos.reshape(-1, 3).astype(np.float32)
