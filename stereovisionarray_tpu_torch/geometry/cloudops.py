"""Point-cloud post-processing on the host: voxel downsampling and
density-based outlier removal for fused clouds (a numpy copy of
``stereovisionarray_tpu/geometry/cloudops.py``; the port keeps its own copy so
that it imports nothing of the JAX package).

  - :func:`voxel_downsample` — one representative (confidence-weighted
    centroid) per occupied voxel, bounding cloud size independently of
    image resolution;
  - :func:`remove_outliers` — drop points whose 3x3x3 voxel neighbourhood
    holds too few points (grid-density form of statistical outlier
    removal: O(N) via voxel hashing, and deterministic).

Their shapes are data-dependent (unique voxels), and they run after the
device pipeline on compacted clouds, so they stay in numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["voxel_downsample", "remove_outliers"]


def _voxel_keys(points: np.ndarray, voxel: float) -> Tuple[np.ndarray, np.ndarray]:
    """Integer voxel coords (N, 3) and a collision-free linear key (N,)."""
    ijk = np.floor(points / voxel).astype(np.int64)
    ijk -= ijk.min(axis=0, keepdims=True)  # non-negative
    dims = ijk.max(axis=0) + 1
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    return ijk, key


def voxel_downsample(
    points: np.ndarray,
    voxel: float,
    weights: Optional[np.ndarray] = None,
    attributes: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One point per occupied voxel: the (weighted) centroid of its members.

    Args:
      points: (N, 3).
      voxel: cell edge length (world units).
      weights: optional (N,) per-point weights (e.g. fusion confidence);
        default uniform. Returned per-cell weight is the SUM (evidence
        accumulates).
      attributes: optional (N,) or (N, C) extra channels (e.g. intensity),
        averaged with the same weights.

    Returns (points (M, 3), weights (M,), attributes or None), M = number
    of occupied voxels, deterministic order (sorted by voxel key).
    """
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    if n == 0:
        return points.astype(np.float32), np.zeros(0, np.float32), (
            None if attributes is None else np.asarray(attributes)[:0]
        )
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    _, key = _voxel_keys(points, float(voxel))
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    group_start = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    gid = np.cumsum(group_start) - 1  # (N,) group index per sorted point
    m = int(gid[-1]) + 1
    w_s = w[order]
    # bincount over the dense group ids: ~10x np.add.at on large clouds
    wsum = np.bincount(gid, weights=w_s, minlength=m)
    pw = points[order] * w_s[:, None]
    cent = np.stack(
        [np.bincount(gid, weights=pw[:, c], minlength=m) for c in range(3)],
        axis=-1,
    )
    cent /= np.maximum(wsum, 1e-12)[:, None]
    out_attr = None
    if attributes is not None:
        a = np.asarray(attributes, np.float64)[order]
        a2 = a[:, None] if a.ndim == 1 else a
        aw = a2 * w_s[:, None]
        acc = np.stack(
            [np.bincount(gid, weights=aw[:, c], minlength=m)
             for c in range(a2.shape[1])],
            axis=-1,
        )
        acc /= np.maximum(wsum, 1e-12)[:, None]
        out_attr = acc[:, 0] if a.ndim == 1 else acc
        out_attr = out_attr.astype(np.float32)
    return cent.astype(np.float32), wsum.astype(np.float32), out_attr


def remove_outliers(
    points: np.ndarray,
    voxel: float,
    min_neighbors: int = 3,
) -> np.ndarray:
    """Boolean keep-mask: a point survives when its 3x3x3 voxel
    neighbourhood (including its own cell) holds more than ``min_neighbors``
    points besides itself.

    Grid-density outlier removal: isolated speckle from wrong matches lands
    in sparsely-populated cells, real surfaces are locally dense. ``voxel``
    should be a few times the expected point spacing.
    """
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    ijk, _ = _voxel_keys(points, float(voxel))
    dims = ijk.max(axis=0) + 3  # +1 for size, +2 for the shifted copies
    ijk1 = ijk + 1  # shift so the 3x3x3 window never underflows

    def lin(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    base = lin(ijk1)
    uniq, cnt = np.unique(base, return_counts=True)
    # neighbourhood count per point: sum of occupancy over the 27 cells
    # (vectorized membership via searchsorted on the sorted unique keys)
    neigh = np.zeros(n, np.int64)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off = (dx * dims[1] + dy) * dims[2] + dz
                keys = base + off
                pos = np.clip(np.searchsorted(uniq, keys), 0, len(uniq) - 1)
                neigh += np.where(uniq[pos] == keys, cnt[pos], 0)
    return (neigh - 1) > min_neighbors  # exclude the point itself
