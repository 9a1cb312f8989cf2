"""The port's serve loop (models/serving.py, parallel/streaming.py) on the
CPU: every streamed output equals a direct array_depth_pipeline call on the
same frame-set, and every filtered map the port's temporal_update over those
outputs in order (bit for bit: the loop adds no arithmetic); the per-set
outputs match the reference's kernel route as tests/test_torch_array_pipeline.py
holds them; frame_sets_from_dirs decodes the port's PNGs as the JAX
package's loader does; the executor keeps at most `depth` frames in flight."""

import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import EngineConfig as JaxConfig
from stereovisionarray_tpu.datasets import load_image_stack as jax_load_image_stack
from stereovisionarray_tpu.datasets import reference_rig as jax_rig
from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.datasets import io
from stereovisionarray_tpu_torch.datasets.synthetic import (
    SceneSpec,
    reference_rig,
    render_camera_array,
)
from stereovisionarray_tpu_torch.models import (
    TemporalParams,
    array_baselines,
    array_depth_pipeline,
    frame_sets_from_dirs,
    stream_depth_maps,
    stream_depth_maps_chunked,
    stream_temporal,
    temporal_init,
    temporal_update,
)
from stereovisionarray_tpu_torch.models.two_view import disparity_to_depth
from stereovisionarray_tpu_torch.parallel import StreamExecutor, throughput_stream, to_device

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_array_pipeline import _reference_route  # noqa: E402

RES = (48, 64)
SETS = 5
CFG = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                 "plane_sweep.num_planes": 32, "refine.radius": 2,
                                 "refine.window": 9, "sgm.num_paths": 4})
CASCADE = CFG.override(**{"plane_sweep.cascade": True, "plane_sweep.cascade_coarse_factor": 2,
                          "plane_sweep.cascade_fine_planes": 16,
                          "plane_sweep.cascade_band_step": 4})
OUTPUT_FIELDS = ("depth", "refined_depth", "disparity", "refined_disparity", "valid", "mask")
SWEEP_FIELDS = ("depth", "plane", "cost", "valid", "num_views", "confidence")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs six workers
    on the machine's cores, and ops split over every core in each worker
    oversubscribe them (a pipeline call then ran a hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The 3x3 rig of tests/test_serving.py:23-39 and five frame-sets: three
    textures, one repeated, and one with a band of views darkened (holes)."""
    cams = reference_rig(rows=3, cols=3, resolution=RES)
    frames = [np.round(render_camera_array(cams, RES, SceneSpec(texture_seed=s))[0])
              for s in (0, 1, 1, 2, 0)]
    frames[3][:, 20:30, :] = 0.0
    _, b0 = array_baselines(cams, 4, (1, 3, 5, 7))
    params = TemporalParams(baseline=b0, focal_px=float(cams.host().fx[4]), max_diff=1.5)
    return cams, frames, params


def _same(a, b):
    for f in OUTPUT_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in SWEEP_FIELDS:
        assert torch.equal(getattr(a.sweep, f), getattr(b.sweep, f)), f"sweep.{f}"


def _direct(frames, cams, cfg):
    return [array_depth_pipeline(torch.from_numpy(f), cams, cfg, ref_index=4) for f in frames]


def _filtered(outs, params):
    """The port's filter over direct outputs: (temporal output, depth) each."""
    state, res = temporal_init(tuple(outs[0].refined_disparity.shape)), []
    for out in outs:
        state, tout = temporal_update(state, out.refined_disparity, out.valid,
                                      out.sweep.confidence, max_diff=params.max_diff,
                                      max_weight=params.max_weight,
                                      max_hole_age=params.max_hole_age)
        depth = torch.where(tout.valid, disparity_to_depth(tout.disparity, params.baseline,
                                                           params.focal_px), 0.0)
        res.append((tout, depth))
    return res


@pytest.fixture(scope="module")
def direct(setup):
    cams, frames, params = setup
    outs = _direct(frames, cams, CFG)
    return outs, _filtered(outs, params)


def _check(results, direct_outs, filtered=None):
    assert [r.index for r in results] == list(range(SETS))
    for r, want in zip(results, direct_outs):
        _same(r.output, want)
        assert r.decode_s >= 0.0
    if filtered is not None:
        for r, (tout, depth) in zip(results, filtered):
            for f in ("disparity", "valid", "stability", "coasted"):
                assert torch.equal(getattr(r.temporal, f), getattr(tout, f)), f
            assert torch.equal(r.depth, depth)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_depth_maps_equals_direct_calls(setup, direct, depth):
    cams, frames, _ = setup
    _check(list(stream_depth_maps(iter(frames), cams, CFG, ref_index=4, depth=depth,
                                  device="cpu")), direct[0])


def test_stream_temporal_equals_the_filter_over_direct_calls(setup, direct):
    cams, frames, params = setup
    results = list(stream_temporal(
        stream_depth_maps(iter(frames), cams, CFG, ref_index=4, device="cpu"),
        params.baseline, params.focal_px, max_diff=params.max_diff))
    _check(results, *direct)
    stab = [float(r.temporal.stability.mean()) for r in results]
    assert stab[1] < stab[2]  # the repeated set adds evidence


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("temporal", [False, True])
def test_chunked_stream_equals_direct_calls(setup, direct, chunk, temporal):
    """chunk 2 and 3 over 5 sets end in a ragged, padded chunk whose padding
    is dropped; the filter's state crosses the chunk boundaries."""
    cams, frames, params = setup
    results = list(stream_depth_maps_chunked(iter(frames), cams, CFG, ref_index=4, chunk=chunk,
                                             temporal=params if temporal else None,
                                             device="cpu"))
    _check(results, direct[0], direct[1] if temporal else None)


def test_chunked_uint8_transfer_upcasts_on_the_device(setup, direct):
    cams, frames, _ = setup
    results = list(stream_depth_maps_chunked(iter(frames), cams, CFG, ref_index=4, chunk=2,
                                             transfer_dtype=np.uint8, device="cpu"))
    _check(results, direct[0])  # the frames are whole numbers in [0, 255]


def test_chunked_stream_with_a_cascade_config(setup):
    cams, frames, _ = setup
    results = list(stream_depth_maps_chunked(iter(frames), cams, CASCADE, ref_index=4, chunk=2,
                                             device="cpu"))
    _check(results, _direct(frames, cams, CASCADE))


def test_streamed_sets_match_the_reference_route(setup):
    """Streamed sets against the reference's kernel route, in the
    configuration and with the bounds of tests/test_torch_array_pipeline.py's
    small-rig test (at 32 planes the warp's contracted lerp in the reference
    moves more fractional planes: ROADMAP.md queue 3, border rings and
    compiled float arithmetic)."""
    cams, frames, _ = setup
    cfg = CFG.override(**{"plane_sweep.num_planes": 16, "plane_sweep.topology": "CROSS",
                          "refine.window": 7, "sgm.num_paths": 8})
    jcams = jax_rig(rows=3, cols=3, resolution=RES)
    results = stream_depth_maps(iter(frames[:2]), cams, cfg, ref_index=4, device="cpu")
    for r, images in zip(results, frames[:2]):
        got = r.output
        sweep, refined, _ = _reference_route(images, jcams, JaxConfig.from_dict(cfg.to_dict()), 4,
                                             np.ones(RES, bool))
        assert (got.valid.numpy() == np.asarray(sweep.valid)).mean() > 0.99
        assert (got.sweep.plane.numpy() == np.asarray(sweep.plane)).mean() > 0.99
        both = got.valid.numpy() & np.asarray(sweep.valid)
        d = np.abs(got.refined_disparity.numpy() - np.asarray(refined))[both]
        assert (d <= 1e-3).mean() > 0.98


def test_frame_sets_from_dirs_round_trip(setup, tmp_path):
    """PNGs written by the port's save_png decode to the frames (whole
    numbers in [0, 255]) through the port's loader and through the JAX
    package's load_image_stack alike."""
    cams, frames, _ = setup
    dirs = []
    for i, imgs in enumerate(frames[:2]):
        d = tmp_path / f"frame_{i}"
        d.mkdir()
        for j, img in enumerate(imgs):
            io.save_png(str(d / f"view_{j:03d}.png"), img, vmin=0.0, vmax=255.0)
        (d / "notes.txt").write_text("not an image")
        dirs.append(str(d))
    stacks = list(frame_sets_from_dirs(dirs))
    assert len(stacks) == 2
    for stack, d, want in zip(stacks, dirs, frames):
        assert stack.dtype == np.float32 and np.array_equal(stack, want)
        paths = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".png"))
        assert np.array_equal(stack, jax_load_image_stack(paths))
    half = next(frame_sets_from_dirs(dirs[:1], half_res=True))
    assert np.array_equal(half, frames[0][:, ::2, ::2])
    with pytest.raises(ValueError, match="no images"):
        next(frame_sets_from_dirs([str(tmp_path)]))


@pytest.mark.parametrize("chunk", [1, 2])
def test_decode_s_counts_the_sources_read(setup, chunk):
    """A source that takes 20 ms to hand over each set (a read and decode)
    shows in every set's decode_s, per-set and chunked alike."""
    cams, frames, _ = setup

    def slow_source():
        for f in frames[:2]:
            time.sleep(0.02)
            yield f

    results = list(stream_depth_maps_chunked(slow_source(), cams, CFG, ref_index=4, chunk=chunk,
                                             device="cpu"))
    assert len(results) == 2 and all(r.decode_s >= 0.02 for r in results)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_executor_bounds_frames_in_flight(depth):
    pulled, consumed = [], 0

    def gen():
        for i in range(10):
            pulled.append(i)
            yield np.full((4,), float(i), dtype=np.float32)

    for out in StreamExecutor(lambda x: x + 1, depth=depth, device="cpu").run(gen()):
        assert len(pulled) <= consumed + depth  # at most `depth` ahead of the consumer
        assert torch.equal(out, torch.full((4,), consumed + 1.0))
        consumed += 1
    assert consumed == 10


def test_throughput_stream_and_to_device():
    frames = [np.full((8, 8), float(i), dtype=np.float32) for i in range(6)]
    outs, fps = throughput_stream(lambda x: x * 2.0, frames, depth=2, device="cpu")
    assert [float(o[0, 0]) for o in outs] == [2.0 * i for i in range(6)] and fps > 0
    u8 = to_device(np.arange(4, dtype=np.uint8), "cpu")
    assert u8.dtype == torch.uint8 and u8.tolist() == [0, 1, 2, 3]
