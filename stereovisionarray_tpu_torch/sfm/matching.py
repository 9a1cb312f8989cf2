"""Descriptor matching: mutual nearest neighbour and Lowe's ratio test (twin
of ``stereovisionarray_tpu/sfm/matching.py``).

One (F_a x F_b) cosine-similarity product per view pair of L2-normalized
descriptors, batched over leading dims (every view against the reference in
one call). The product runs in full float32 whatever the caller's TF32
setting, as the reference's ``Precision.HIGHEST``; ``torch.argmax`` returns
the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovisionarray_tpu_torch.backend import float32_matmuls

__all__ = ["Matches", "match_descriptors"]


class Matches(NamedTuple):
    idx_a: torch.Tensor  # (..., F) int32 index into a's features (the identity)
    idx_b: torch.Tensor  # (..., F) int32 best match in b
    score: torch.Tensor  # (..., F) cosine similarity of the match
    valid: torch.Tensor  # (..., F) bool: passed the mutual and ratio tests


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor,
                      valid_b: torch.Tensor, ratio: float = 0.9,
                      min_score: float = 0.5) -> Matches:
    """Match normalized descriptors (..., F, K) of a against b.

    valid = mutual nearest neighbour AND second-best similarity below the
    Lowe bound (on distances, d^2 = 2 - 2 s) AND best similarity >=
    min_score AND a's feature valid."""
    with float32_matmuls():
        sim = desc_a @ desc_b.transpose(-1, -2)
    neg = -2.0
    sim = torch.where(valid_a[..., :, None] & valid_b[..., None, :], sim, neg)
    best_b = torch.argmax(sim, dim=-1)  # (..., Fa) first maximum
    best_sim = torch.gather(sim, -1, best_b[..., None])[..., 0]
    second_sim = sim.scatter(-1, best_b[..., None], neg).amax(dim=-1)
    best_a_of_b = torch.argmax(sim, dim=-2)  # (..., Fb)
    idx_a = torch.arange(sim.shape[-2], device=sim.device)
    mutual = torch.gather(best_a_of_b, -1, best_b) == idx_a
    # the reference squares the ratio in float32 (a traced weak-typed scalar)
    r2 = torch.tensor(ratio, dtype=torch.float32) ** 2
    lowe = (1.0 - best_sim) < r2 * (1.0 - second_sim)
    valid = mutual & lowe & (best_sim >= min_score) & valid_a
    return Matches(idx_a=idx_a.to(torch.int32).expand_as(best_b), idx_b=best_b.to(torch.int32),
                   score=best_sim, valid=valid)
