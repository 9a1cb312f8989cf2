"""Deterministic segment sums over a fixed observation list.

The reference sums per-camera and per-point blocks with
``jax.ops.segment_sum``. On the card a scatter-add (``index_add_``) adds
floats with atomics, in an order that changes from run to run; over 60 LM
steps with tukey cuts and accept / reject decisions that drift changes the
result. The observation indices are fixed for a whole solve, so
:class:`Segments` lays them out once, on the host, as a (segments, slots)
table of observation numbers (padding points at a zero row), and a segment
sum is a gather and a sum over the slots: one order on every run and device,
no atomics, and no host read.
"""

from __future__ import annotations

import numpy as np
import torch

from stereovisionarray_tpu_torch.backend import host_to_device

__all__ = ["Segments", "host_indices"]


def host_indices(idx) -> np.ndarray:
    """An index array given as numpy, a list or a CPU tensor, as int64 numpy.
    A CUDA tensor is refused: reading it would wait for the card."""
    if isinstance(idx, torch.Tensor):
        if idx.is_cuda:
            raise ValueError("observation indices must be host arrays (numpy or CPU tensors): "
                             "their segment layout is built on the host")
        idx = idx.numpy()
    return np.asarray(idx, dtype=np.int64)


class Segments:
    """The layout of M observations into `num_segments` segments by
    `segment_ids` (host, (M,)); ids outside [0, num_segments) are dropped, as
    ``segment_sum`` drops them."""

    def __init__(self, segment_ids, num_segments: int, device):
        ids = host_indices(segment_ids)
        m = ids.shape[0]
        keep = (ids >= 0) & (ids < num_segments)
        order = np.argsort(np.where(keep, ids, num_segments), kind="stable")[: int(keep.sum())]
        counts = np.bincount(ids[order], minlength=num_segments)
        starts = np.cumsum(counts) - counts
        table = np.full((num_segments, max(int(counts.max(initial=0)), 1)), m, dtype=np.int64)
        table[ids[order], np.arange(order.size) - starts[ids[order]]] = order
        self.table = host_to_device(table, device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) per-observation values -> (num_segments, ...) sums."""
        padded = torch.cat([x, torch.zeros_like(x[:1])])
        return padded[self.table].sum(dim=1)
