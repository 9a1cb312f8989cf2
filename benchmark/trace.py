"""The profiler's record of a window, reduced to what the readers need.

The record stays in memory: no trace file is written. :class:`Recorder`
runs ``torch.profiler`` over a window, with the card's activity alone (the
end-to-end device time) or with the host's too (the per-layer metrics, the
idle gaps and what the host was doing in them). :class:`Trace` holds the
device activities (kernels, copies, fills) and the host events as numpy
arrays, and answers sums, unions and gaps over them.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

COPY_PREFIXES = ("Memcpy", "Memset")
CSRC = Path(__file__).resolve().parents[1] / "stereovisionarray_tpu_torch" / "csrc"


def port_kernel_names(csrc: Path = CSRC) -> Tuple[str, ...]:
    """The ``__global__`` function names of the port's CUDA sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                                r"(?:void\s+)?(\w+)\s*\(", src.read_text()))
    return tuple(sorted(names))


class Trace:
    """Device activities ``(name, start_ns, duration_ns)`` and host events
    ``(name, start_ns, end_ns)`` of one window."""

    def __init__(self, device: Sequence[Tuple[str, int, int]],
                 host: Sequence[Tuple[str, int, int]] = ()):
        self.dev_names = [d[0] for d in device]
        self.dev_start = np.array([d[1] for d in device], dtype=np.int64)
        self.dev_dur = np.array([d[2] for d in device], dtype=np.int64)
        self.host_names = [e[0] for e in host]
        self.host_start = np.array([e[1] for e in host], dtype=np.int64)
        self.host_end = np.array([e[2] for e in host], dtype=np.int64)

    def kernel_mask(self, *patterns: str) -> np.ndarray:
        """Kernels (not copies) whose name contains any of `patterns`
        (every kernel without patterns)."""
        return np.array([not n.startswith(COPY_PREFIXES)
                         and (not patterns or any(p in n for p in patterns))
                         for n in self.dev_names], dtype=bool)

    def device_s(self, mask: Optional[np.ndarray] = None) -> float:
        """Summed device time of the masked activities, seconds."""
        d = self.dev_dur if mask is None else self.dev_dur[mask]
        return float(d.sum()) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """(K, 2) merged [start, end) ns of every device activity."""
        if not len(self.dev_start):
            return np.zeros((0, 2), dtype=np.int64)
        order = np.argsort(self.dev_start, kind="stable")
        s, e = self.dev_start[order], self.dev_start[order] + self.dev_dur[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]]
        return np.stack([starts, ends], axis=1)

    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device (their union)."""
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def span_s(self, *names: str) -> float:
        """Summed duration of the host events named `names`, seconds."""
        keep = np.array([n in names for n in self.host_names], dtype=bool)
        if not keep.any():
            return 0.0
        return float((self.host_end[keep] - self.host_start[keep]).sum()) / 1e9

    def top_device_ops(self, k: int = 10) -> List[List]:
        """The k device operations that took most time: [name, seconds]."""
        totals: dict = {}
        for name, dur in zip(self.dev_names, self.dev_dur.tolist()):
            totals[name] = totals.get(name, 0) + dur
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[short(n), v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest gaps between device activities, each named by the
        host events open at its middle (outermost first, two levels):
        [name, seconds]."""
        iv = self.busy_intervals()
        if len(iv) < 2:
            return []
        gaps = np.stack([iv[:-1, 1], iv[1:, 0]], axis=1)
        longest = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:k]
        out = []
        for g in longest:
            mid = (gaps[g, 0] + gaps[g, 1]) // 2
            open_ = np.flatnonzero((self.host_start <= mid) & (self.host_end >= mid))
            names = [self.host_names[i] for i in open_[np.argsort(self.host_start[open_],
                                                                  kind="stable")]][:2]
            out.append(["/".join(short(n, 40) for n in names) or "host",
                        float(gaps[g, 1] - gaps[g, 0]) / 1e9])
        return out


def short(name: str, n: int = 64) -> str:
    """A kernel or op name cut to `n` characters, on one line."""
    return " ".join(name.split())[:n]


class Recorder:
    """``torch.profiler`` over one window; :meth:`trace` reads the record
    without building the profiler's per-event Python objects."""

    def __init__(self, torch, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        self.torch = torch
        self.host = host
        self.prof = profile(activities=acts, record_shapes=False, with_stack=False)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        DeviceType = self.torch.autograd.DeviceType
        device, host = [], []
        for e in _events(self.prof):
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                if not _annotation(e):  # a host span's shadow on the card: no work
                    device.append((e.name(), *_times(e)))
            elif self.host and kind == DeviceType.CPU:
                start, dur = _times(e)
                host.append((e.name(), start, start + dur))
        return Trace(device, host)


def _annotation(e) -> bool:
    """True for the card's copy of a ``record_function`` span."""
    return bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else (
        e.name().startswith("bench."))


def _times(e) -> Tuple[int, int]:
    """(start, duration) of a raw event in ns; older releases give us."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


def _events(prof) -> Iterable:
    """The raw events of a finished ``torch.profiler.profile``."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no record of the window")
    return results.events()
