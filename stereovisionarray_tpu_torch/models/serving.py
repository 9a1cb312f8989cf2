"""The streaming serve loop over camera-array frame-sets (twin of
``stereovisionarray_tpu/models/serving.py``):

  decode (the C++ prefetch loader, or the port's PNG decoder)
    -> host-to-device copy (pinned, ``non_blocking``, bounded look-ahead)
      -> the array pipeline (K8, K2/K3, K4 on the card; K9 under a cascade)
        -> the temporal filter (optional, its state kept on the card)
          -> in-order results.

:func:`stream_depth_maps` runs one pipeline call a frame-set;
:func:`stream_depth_maps_chunked` copies K frame-sets to the card in one
transfer and runs K calls on it (the reference's ``lax.map`` over a chunk),
with the filter carried from set to set on the device (its ``lax.scan``).
Every output equals a direct :func:`array_depth_pipeline` call on the same
set, and the filtered maps equal :func:`temporal_update` over them in order.
Only the consumer waits for the card.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.models.array_pipeline import (
    ArrayPipelineOutput,
    array_depth_pipeline,
)
from stereovisionarray_tpu_torch.models.temporal import (
    TemporalOutput,
    TemporalState,
    temporal_init,
    temporal_update,
)
from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth
from stereovisionarray_tpu_torch.parallel.streaming import StreamExecutor

__all__ = [
    "FrameResult",
    "TemporalFrameResult",
    "TemporalParams",
    "frame_sets_from_dirs",
    "stream_depth_maps",
    "stream_depth_maps_chunked",
    "stream_temporal",
]


class FrameResult(NamedTuple):
    index: int
    output: ArrayPipelineOutput
    decode_s: float  # host time to read and convert this frame-set


class TemporalFrameResult(NamedTuple):
    index: int
    output: ArrayPipelineOutput  # the raw per-set pipeline result
    temporal: TemporalOutput  # filtered disparity / valid / stability maps
    depth: torch.Tensor  # (H, W) depth of the filtered disparity
    decode_s: float


class TemporalParams(NamedTuple):
    """Temporal-filter settings of the serve loop (``models/temporal.py``)."""

    baseline: float  # metric baseline B0 (``array_baselines``) for depth
    focal_px: float  # reference view's fx
    max_diff: float = 1.0
    max_weight: float = 8.0
    max_hole_age: int = 3


def frame_sets_from_dirs(dirs: Sequence[str], half_res: bool = False,
                         threads: int = 4) -> Iterator[np.ndarray]:
    """Decode each directory of array views (sorted by name) into an
    (N, H, W) float32 stack; ``datasets.native_available()`` says which
    decoder ran."""
    from stereovisionarray_tpu_torch.datasets.io import list_images_sorted, load_image_stack

    for d in dirs:
        paths = list_images_sorted(d)
        if not paths:
            raise ValueError(f"no images in {d!r}")
        yield load_image_stack(paths, half_res=half_res, threads=threads)


def _host_frames(frame_sets: Iterable[np.ndarray], transfer_dtype, times: List[float]):
    """Each frame-set as a contiguous host array in `transfer_dtype`, its
    host time appended to `times`: the pull from `frame_sets` (a source's
    read and decode) and the conversion."""
    it = iter(frame_sets)
    while True:
        t0 = time.perf_counter()
        try:
            frames = next(it)
        except StopIteration:
            return
        host = np.ascontiguousarray(frames)
        if transfer_dtype is not None:
            host = host.astype(transfer_dtype, copy=False)
        times.append(time.perf_counter() - t0)
        yield host


def stream_depth_maps(frame_sets: Iterable[np.ndarray], cameras: CameraArray,
                      cfg: EngineConfig = EngineConfig(), ref_index: Optional[int] = None,
                      use_roi: bool = False, depth: int = 2,
                      transfer_dtype: Optional[np.dtype] = None,
                      device="cuda") -> Iterator[FrameResult]:
    """The array pipeline over a stream of (N, H, W) frame-sets, in order,
    with up to `depth` sets copied and enqueued ahead of the consumer.

    transfer_dtype: dtype of the host-to-device copy (``np.uint8`` for 8-bit
    sources moves a quarter of float32's bytes); the set is cast to float32
    on the device. device: where the pipeline runs (the card by default)."""

    def step(images_dev):
        return array_depth_pipeline(images_dev.to(torch.float32), cameras, cfg,
                                    ref_index=ref_index, use_roi=use_roi)

    times: List[float] = []
    executor = StreamExecutor(step, depth=depth, device=device)
    for i, out in enumerate(executor.run(_host_frames(frame_sets, transfer_dtype, times))):
        yield FrameResult(index=i, output=out, decode_s=times[i])


def _filter_step(state: Optional[TemporalState], out: ArrayPipelineOutput, baseline: float,
                 focal_px: float, max_diff: float, max_weight: float, max_hole_age: int):
    """One filter step on a pipeline output: (state, filtered maps, depth)."""
    disp = out.refined_disparity
    if state is None:
        state = temporal_init(tuple(disp.shape), disp.device)
    state, tout = temporal_update(state, disp, out.valid, out.sweep.confidence,
                                  max_diff=max_diff, max_weight=max_weight,
                                  max_hole_age=max_hole_age)
    depth = torch.where(tout.valid, disparity_to_depth(tout.disparity, baseline, focal_px), 0.0)
    return state, tout, depth


def stream_temporal(results: Iterable[FrameResult], baseline: float, focal_px: float, *,
                    max_diff: float = 1.0, max_weight: float = 8.0,
                    max_hole_age: int = 3) -> Iterator[TemporalFrameResult]:
    """Wrap a :func:`stream_depth_maps` / ``_chunked`` result stream with the
    recursive temporal filter, weighted by the plane sweep's PKRN
    confidence; `baseline` / `focal_px` turn the filtered disparity back into
    depth. The state stays on the card."""
    state = None
    for fr in results:
        state, tout, depth = _filter_step(state, fr.output, baseline, focal_px, max_diff,
                                          max_weight, max_hole_age)
        yield TemporalFrameResult(index=fr.index, output=fr.output, temporal=tout, depth=depth,
                                  decode_s=fr.decode_s)


def stream_depth_maps_chunked(frame_sets: Iterable[np.ndarray], cameras: CameraArray,
                              cfg: EngineConfig = EngineConfig(),
                              ref_index: Optional[int] = None, use_roi: bool = False,
                              depth: int = 2, chunk: int = 8,
                              transfer_dtype: Optional[np.dtype] = None,
                              temporal: Optional[TemporalParams] = None,
                              device="cuda") -> Iterator[FrameResult]:
    """:func:`stream_depth_maps` with K = `chunk` frame-sets a transfer: the
    chunk is stacked on the host, copied to the device at once, and the
    pipeline runs on each set of it in turn. A ragged last chunk is padded
    with its last set and the padding's results are dropped. With
    `temporal`, the filter runs over the sets in order with its state kept
    on the device across chunks, and the stream yields
    :class:`TemporalFrameResult`. ``chunk=1`` is the per-set path."""
    if chunk <= 1:
        base = stream_depth_maps(frame_sets, cameras, cfg, ref_index=ref_index, use_roi=use_roi,
                                 depth=depth, transfer_dtype=transfer_dtype, device=device)
        if temporal is None:
            yield from base
        else:
            yield from stream_temporal(base, temporal.baseline, temporal.focal_px,
                                       max_diff=temporal.max_diff,
                                       max_weight=temporal.max_weight,
                                       max_hole_age=temporal.max_hole_age)
        return

    state_box = {"s": None}  # the filter's state, carried from chunk to chunk

    def step(stack_dev):
        outs = [array_depth_pipeline(images.to(torch.float32), cameras, cfg,
                                     ref_index=ref_index, use_roi=use_roi)
                for images in stack_dev]
        if temporal is None:
            return outs
        filtered = []
        for out in outs:
            state_box["s"], tout, depth_k = _filter_step(
                state_box["s"], out, temporal.baseline, temporal.focal_px, temporal.max_diff,
                temporal.max_weight, temporal.max_hole_age)
            filtered.append((tout, depth_k))
        return list(zip(outs, filtered))

    meta: List[Tuple[int, List[float]]] = []  # (real sets, host times) a chunk

    def chunks() -> Iterator[np.ndarray]:
        buf: List[np.ndarray] = []
        times: List[float] = []
        for host in _host_frames(frame_sets, transfer_dtype, times):
            buf.append(host)
            if len(buf) == chunk:
                meta.append((chunk, times[-chunk:]))
                yield np.stack(buf)
                buf = []
        if buf:
            meta.append((len(buf), times[-len(buf):]))
            yield np.stack(buf + [buf[-1]] * (chunk - len(buf)))

    executor = StreamExecutor(step, depth=depth, device=device)
    idx = 0
    for ci, outs in enumerate(executor.run(chunks())):
        n_real, times = meta[ci]
        for k in range(n_real):
            if temporal is None:
                yield FrameResult(index=idx, output=outs[k], decode_s=times[k])
            else:
                out, (tout, depth_k) = outs[k]
                yield TemporalFrameResult(index=idx, output=out, temporal=tout, depth=depth_k,
                                          decode_s=times[k])
            idx += 1
