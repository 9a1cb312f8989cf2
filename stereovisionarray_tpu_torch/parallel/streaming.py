"""Streaming execution with bounded look-ahead (twin of
``stereovisionarray_tpu/parallel/streaming.py``; its ``DevicePipeline`` waits
for the port of the sharded paths).

:class:`StreamExecutor` keeps up to `depth` frames in flight: each is copied
to the card from pinned memory without waiting (``non_blocking``) and its
step is enqueued on the current stream, so the host decodes and enqueues
frame t+1 while the card computes frame t. Results come out in order and only
the consumer waits for them. How far ahead the host really gets is bounded by
the step itself: a step whose launches fill the device's launch queue blocks
the host inside it. Pulling a frame from the source (``svt.stream.next``)
and its copy (``svt.stream.copy``) are stage spans (``utils.profiling.span``);
the step's own stages are the pipeline's.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.utils.profiling import span

__all__ = ["StreamExecutor", "throughput_stream", "to_device"]


def to_device(frame, device) -> torch.Tensor:
    """A host frame (numpy array or CPU tensor) on `device`, values and dtype
    unchanged. To a CUDA device it is staged in pinned memory and copied
    without waiting for the stream; the caching host allocator keeps the
    staging buffer until the copy has run."""
    with span("svt.stream.copy"):
        t = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(frame))
        device = torch.device(device)
        if device.type != "cuda" or t.device.type != "cpu":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)


class StreamExecutor:
    """Run `step_fn` over a host frame stream with bounded look-ahead.

    step_fn: takes one frame on `device` and returns its (device) result.
    depth: frames in flight (copied and enqueued) ahead of the consumer.
    device: where frames go; the card unless the caller names the CPU.
    """

    def __init__(self, step_fn: Callable, depth: int = 2, device="cuda"):
        self.step_fn = step_fn
        self.depth = max(1, depth)
        self.device = torch.device(device)

    def run(self, frames: Iterable[Any]) -> Iterator[Any]:
        """Yield step_fn(frame) per frame, in order, with overlap."""
        inflight: collections.deque = collections.deque()
        it = iter(frames)
        exhausted = False
        while not exhausted or inflight:
            while not exhausted and len(inflight) < self.depth:
                try:
                    with span("svt.stream.next"):
                        host_frame = next(it)
                except StopIteration:
                    exhausted = True
                    break
                inflight.append(self.step_fn(to_device(host_frame, self.device)))
            if inflight:
                yield inflight.popleft()


def throughput_stream(step_fn: Callable, frames: Iterable[Any], depth: int = 2,
                      device="cuda") -> Tuple[List[Any], float]:
    """Run a stream to its end: (outputs, frames per second). Waits for each
    output's own work on the card (an event recorded after its step), so the
    rate counts finished work; a device-wide synchronize would also wait for
    the frames enqueued after it and undo the look-ahead."""
    on_card = torch.device(device).type == "cuda"

    def step(frame):
        out = step_fn(frame)
        if not on_card:
            return out, None
        done = torch.cuda.Event()
        done.record()
        return out, done

    outputs = []
    t0 = time.perf_counter()
    for out, done in StreamExecutor(step, depth=depth, device=device).run(frames):
        if done is not None:
            done.synchronize()
        outputs.append(out)
    dt = time.perf_counter() - t0
    return outputs, (len(outputs) / dt if dt > 0 else float("inf"))
