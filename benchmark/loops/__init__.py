"""The loops that drive a pipeline through the measured window, one file
each: ``loops/<name>.py`` holds a class ``Loop`` that subclasses
:class:`Loop` here, and a traffic file picks one by its ``loop``.

Every loop stops handing units over once ``seconds`` have passed and counts
every unit handed over. Inside the window the harness allocates nothing and
collects no garbage: the pool, any pinned buffers, the latency array and
the seeded choice of the units the check compares are made before it.
"""

from __future__ import annotations

import contextlib
import gc
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from benchmark import parts

_NO_SPAN = contextlib.nullcontext()


def no_span(name: str):
    return _NO_SPAN


class Window(NamedTuple):
    units: int  # units handed over and completed
    seconds: float  # host clock from the first handover to the last result
    latencies: Optional[np.ndarray]  # per unit, seconds (closed loops)
    samples: List  # (pool index, device output, host maps or None) per checked unit


def sample_slots(seed: int, k: int, n_max: int) -> np.ndarray:
    """Reservoir choice of `k` of the first n units, whatever n <= `n_max`
    turns out to be: entry i is the sample slot unit i takes, or -1."""
    rng = np.random.default_rng([seed, 1])
    slots = np.full(n_max, -1, dtype=np.int64)
    slots[:k] = np.arange(min(k, n_max))
    j = (rng.random(n_max) * (np.arange(n_max) + 1)).astype(np.int64)
    keep = (np.arange(n_max) >= k) & (j < k)
    slots[keep] = j[keep]
    return slots


class Loop:
    """One cell's traffic over one pipeline and pool; a loop file's ``Loop``
    gives :meth:`window`."""

    def __init__(self, torch, pipe, pool: List[np.ndarray], traffic: Dict, seed: int):
        self.torch, self.pipe, self.pool, self.traffic, self.seed = torch, pipe, pool, traffic, seed
        self.k = int(traffic["check"])

    def run(self, seconds: float, n_max: int, spans=None) -> Window:
        """Run the traffic for `seconds` (at most `n_max` units); `spans`
        is ``torch.profiler.record_function`` in a traced window."""
        slots = sample_slots(self.seed, self.k, n_max)
        gc.collect()
        gc.disable()
        try:
            return self.window(seconds, slots, spans or no_span)
        finally:
            gc.enable()

    def window(self, seconds: float, slots: np.ndarray, spans) -> Window:
        """Hand units over for `seconds`; unit i with ``slots[i] >= 0`` is
        kept in ``samples[slots[i]]``; ``spans(name)`` opens a span."""
        raise NotImplementedError


def make(torch, pipe, pool: List[np.ndarray], traffic: Dict, seed: int,
         base: Path = parts.HERE) -> Loop:
    """The loop the traffic file names, from ``<base>/loops/<loop>.py``."""
    return parts.find(base, "loops", traffic["loop"], "Loop")(torch, pipe, pool, traffic, seed)
