"""Timing and tracing (twin of ``stereovisionarray_tpu/utils/profiling.py``):

 - :func:`time_fn`: steady-state seconds per call, fenced by a synchronize
   of every card the result lives on (the reference's ``block_until_ready``);
 - :class:`StageTimer`: wall-clock per named stage, each stage fenced by a
   synchronize of the card (the reference's ``jax.effects_barrier``);
 - :func:`trace`: ``torch.profiler`` over the host and, where there is one,
   the card, written as a Chrome trace;
 - :func:`span`: the program's own stage spans (``svt.*``), recorded only
   while a profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

from stereovisionarray_tpu_torch.utils.debug import leaves_with_paths

__all__ = ["StageTimer", "span", "time_fn", "trace"]

_NO_SPAN = contextlib.nullcontext()


def _fence(tree: Any) -> None:
    """Wait until the work that produced the tensors of `tree` has run."""
    for dev in {leaf.device for _, leaf in leaves_with_paths(tree)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs) -> float:
    """Mean steady-state seconds per call of ``fn(*args, **kwargs)``, the
    calls enqueued back to back and the last result fenced."""
    for _ in range(warmup):
        _fence(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _fence(out)
    return (time.perf_counter() - t0) / iters


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("cost"):
    ...     vol = build(...)  # doctest: +SKIP
    >>> t.report()  # doctest: +SKIP
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        """Time the block; with `sync`, the card's queued work is waited for
        before the clock stops, so the stage owns its device time (nothing to
        wait for on a run that never touched a card)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def __str__(self) -> str:
        return " | ".join(
            f"{k}: {v * 1000:.1f}ms/{self.counts[k]}" for k, v in self.totals.items()
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: ``with trace('traces/run'): run()`` writes
    ``trace.json`` (Chrome trace format, host ops and, on a CUDA machine,
    the card's kernels) into `log_dir`; open it in Perfetto or
    ``chrome://tracing``. Yields the profiler. The program's stage spans
    (``svt.two_view.*``, ``svt.array.*``, ``svt.sweep.*``, ``svt.refine.*``,
    ``svt.stream.*``; :func:`span`) appear in it as host ranges on the same
    clock as the kernels they launch."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _profiler_on() -> bool:
    """torch's own flag: set while a ``torch.profiler.profile`` is entered."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    return torch._C._autograd._profiler_enabled() if flag is None else flag


def span(name: str):
    """A stage span: ``with span("svt.two_view.sgm"): ...``.

    While a profiler runs it is ``torch.profiler.record_function(name)``, a
    host range in the profiler's record, on the clock of the card's kernels
    and copies. Otherwise it is one shared null context, so a run with no
    profiler pays a flag test and creates no range. The program's spans
    mark the stage boundaries of its hot paths, one level deep: no ``svt.*``
    span opens inside another, so a profile's gaps on the card are named by
    the stage that held the host."""
    if _profiler_on():
        return torch.profiler.record_function(name)
    return _NO_SPAN
