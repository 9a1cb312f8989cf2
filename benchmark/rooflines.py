"""The least work of each kernel and the peaks it is held against.

Frozen copies of ``chip_smoke.k1_bound`` and of the bound column of the
kernel table (``PERF.md``): each input byte read once and each output byte
written once, and the scalar operations the algorithm needs, computed from
the shapes alone, whatever implements them. A kernel's bound is the larger of
bytes over the HBM rate and operations over the float32 peak; its roofline
share is that bound over its measured device time.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s, float32 operations/s
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def cost_volume(h: int, w: int, D: int, window: Tuple[int, int],
                element_bytes: int) -> Tuple[int, int]:
    """K1: both float32 images read once, the (H, W, D) volume written once;
    two operations a 64-bit census word (XOR, popcount) and 14 for BT and
    the store an element."""
    n_words = -(-(window[0] * window[1] - 1) // 64)
    return 2 * h * w * 4 + h * w * D * element_bytes, h * w * D * (2 * n_words + 14)


def sgm_paths(h: int, w: int, D: int, cost_bytes: int, num_paths: int = 8) -> Tuple[int, int]:
    """K2/K3: the cost volume and the two int16 P2 maps read once, the
    int16 total written once; 8 operations a path step (neighbour and jump
    minima, the P1 add, two subtractions and adds)."""
    hw, hwd = h * w, h * w * D
    return hwd * cost_bytes + 2 * hw * 2 + hwd * 2, 8 * hwd * num_paths


def extract_maps(h: int, w: int, D: int, lr: bool) -> Tuple[int, int]:
    """K4 (K5's check fused when `lr`): the int16 total read once and the
    left disparity, cost, second-best cost (float32) and validity written;
    6 operations an element with the right view and the LR test's 4 a
    pixel, else 4 an element."""
    hw, hwd = h * w, h * w * D
    return hwd * 2 + hw * 13, hwd * (6 if lr else 4) + hw * (4 if lr else 0)


def plane_sweep(h: int, w: int, D: int, n_src: int) -> Tuple[int, int]:
    """K8: the reference and its sources (float32) read once, the (D, S, 2)
    shift table, the fused float32 volume and the int32 view count written;
    60 operations a pixel, plane and source (bilinear warp, census compares
    and packs, XOR and popcount)."""
    hw = h * w
    return (n_src + 1) * hw * 4 + n_src * D * 8 + hw * D * 8, n_src * hw * D * 60


def bound_ms(nbytes: int, ops: int) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    t_ops = ops / PEAKS["f32_ops_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
