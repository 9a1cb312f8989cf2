"""Arithmetic over the program's own stage spans (``svt.*``, which the port
opens with ``utils.profiling.span`` while a profiler runs) in a traced
window's host events: the union of the spans of one stage family, how much
of the card's idle gaps that union covers, and the kernel launches issued
inside it. A reader returns None where the window holds no span of its
family (a program without the spans, or an untraced run)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark.trace import Trace

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # CUDA runtime and low-level API launches


def union(trace: Trace, prefix: str) -> np.ndarray:
    """(K, 2) merged [start, end) ns of the host events named `prefix`*."""
    keep = [i for i, n in enumerate(trace.host_names) if n.startswith(prefix)]
    return Trace([("", trace.host_start[i], trace.host_end[i] - trace.host_start[i])
                  for i in keep]).busy_intervals()


def _covered_before(iv: np.ndarray, t: np.ndarray) -> np.ndarray:
    """ns of the merged intervals `iv` that lie before each time in `t`."""
    cum = np.r_[0, np.cumsum(iv[:, 1] - iv[:, 0])]
    i = np.searchsorted(iv[:, 0], t, side="right")  # intervals that start at or before t
    beyond = np.where(i > 0, np.maximum(iv[np.maximum(i - 1, 0), 1] - t, 0), 0)
    return cum[i] - beyond


def idle_covered_s(trace: Trace, prefix: str) -> float:
    """Seconds of the gaps between the card's busy intervals that the
    `prefix` spans cover, summed over the gaps."""
    iv, busy = union(trace, prefix), trace.busy_intervals()
    if not len(iv) or len(busy) < 2:
        return 0.0
    g0, g1 = busy[:-1, 1], busy[1:, 0]
    return float((_covered_before(iv, g1) - _covered_before(iv, g0)).sum()) / 1e9


def launches_in(trace: Trace, prefix: str) -> int:
    """Host events named ``cudaLaunchKernel``* or ``cuLaunchKernel``* that
    start inside a `prefix` span."""
    iv = union(trace, prefix)
    keep = np.array([n.startswith(LAUNCHES) for n in trace.host_names], dtype=bool)
    if not len(iv) or not keep.any():
        return 0
    t = trace.host_start[keep]
    i = np.searchsorted(iv[:, 0], t, side="right") - 1
    return int(((i >= 0) & (t < iv[np.maximum(i, 0), 1])).sum())


def _per_unit(run, prefix: str, value) -> Optional[float]:
    """`value`(trace) over the window's units, or None without `prefix` spans."""
    if not run.units or not any(n.startswith(prefix) for n in run.trace.host_names):
        return None
    return value(run.trace) / run.units


def host_ms(run, prefix: str) -> Optional[float]:
    """Host ms a unit inside the `prefix` spans."""
    return _per_unit(run, prefix, lambda t: 1e3 * float(
        np.diff(union(t, prefix), axis=1).sum()) / 1e9)


def idle_ms(run, prefix: str) -> Optional[float]:
    """Card-idle ms a unit that the `prefix` spans cover."""
    return _per_unit(run, prefix, lambda t: 1e3 * idle_covered_s(t, prefix))


def launches(run, prefix: str) -> Optional[float]:
    """Kernel launches a unit issued inside the `prefix` spans."""
    return _per_unit(run, prefix, lambda t: launches_in(t, prefix))
