"""The port's stage spans (``utils.profiling.span``) on the CPU: under
``torch.profiler`` each hot path emits the ``svt.*`` spans of its route,
flat (no ``svt.*`` span inside another) and covering the call (every
operator the call runs lies inside one; counted in events, not in time, so
load on the machine cannot move it); with no profiler running, ``span`` is
one shared null context and records nothing; the outputs are the same bits
with the profiler on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stereovisionarray_tpu_torch.config import CostConfig, EngineConfig, SGMConfig
from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
from stereovisionarray_tpu_torch.models import (
    array_depth_pipeline,
    cascade_two_view_disparity,
    two_view_disparity,
)
from stereovisionarray_tpu_torch.parallel import StreamExecutor
from stereovisionarray_tpu_torch.utils import profiling

TWO_VIEW = {
    "int16": ["prep", "cost", "p2", "sgm", "extract", "confidence", "post"],
    "float32": ["prep", "cost", "p2", "sgm", "extract", "post"],
    "xla": ["prep", "cost", "sgm", "extract", "post"],
}
ARRAY = ["svt.array.prep", "svt.array.prep", "svt.sweep.volume", "svt.sweep.maps",
         "svt.sweep.depth", "svt.array.prep", "svt.refine.stack", "svt.refine.costs",
         "svt.refine.select", "svt.array.prep"]
RIG_RES = (24, 32)
ARRAY_CFG = EngineConfig().override(**{
    "camera.rows": 3, "camera.cols": 3, "plane_sweep.num_planes": 8,
    "plane_sweep.topology": "cross", "refine.iterations": 1, "refine.radius": 2,
    "refine.window": 9, "sgm.num_paths": 4})
COST = CostConfig(num_disparities=16, dtype="int16")
SGM = SGMConfig()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    left = rng.uniform(0.0, 255.0, (24, 40)).astype(np.float32)
    return torch.from_numpy(left), torch.from_numpy(np.roll(left, -4, axis=1).copy())


@pytest.fixture(scope="module")
def rig():
    cams = reference_rig(rows=3, cols=3, resolution=RIG_RES)
    return cams, torch.from_numpy(np.round(render_camera_array(cams, RIG_RES)[0]))


def profiled(fn):
    """fn() under a CPU profiler inside a test span: (result, svt spans
    [(name, start, end)] in order, the names of the operator events inside
    the test span that lie in no svt span). The test's own code, in
    ``test.*`` spans of its own, is left out."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.call"):
            out = fn()
    # the raw record (as benchmark/trace.py reads it): no per-event Python objects
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    call = next((s, e) for n, s, e in events if n == "test.call")
    spans = sorted((ev for ev in events if ev[0].startswith("svt.")), key=lambda ev: ev[1])
    ops = [ev for ev in events if not ev[0].startswith(("svt.", "test."))]
    start = np.array([s for _, s, _ in ops], dtype=np.int64)
    end = np.array([e for _, _, e in ops], dtype=np.int64)
    under = (start >= call[0]) & (end <= call[1])
    mine = [ev for ev in events if ev[0].startswith("test.") and ev[0] != "test.call"]
    for _, s, e in spans + mine:
        under &= ~((start >= s) & (end <= e))
    return out, spans, [ops[i][0] for i in np.flatnonzero(under)]


def assert_flat_and_covering(spans, uncovered=()):
    for (_, _, end), (name, start, _) in zip(spans, spans[1:]):
        assert start >= end, f"{name} opens inside another svt span"
    assert not uncovered, f"operators outside every svt span: {sorted(set(uncovered))}"


def assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.dtype == y.dtype
        elif isinstance(x, tuple):
            assert_same(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("route", sorted(TWO_VIEW))
def test_two_view_spans(pair, route):
    left, right = pair
    if route == "float32":  # the plain float SGM is the slow one on the CPU: a smaller pair
        left, right = left[:12, :24].contiguous(), right[:12, :24].contiguous()
    cost = CostConfig(num_disparities=16, dtype="float32" if route == "float32" else "int16")
    backend = "xla" if route == "xla" else "auto"

    def call():
        return two_view_disparity(left, right, cost, SGM, baseline=0.1, focal_px=50.0,
                                  backend=backend)

    plain = call()  # also the warm-up: the first call in a process loads what it needs
    out, spans, uncovered = profiled(call)
    assert [n for n, _, _ in spans] == [f"svt.two_view.{s}" for s in TWO_VIEW[route]]
    assert_flat_and_covering(spans, uncovered)
    assert_same(out, plain)


# CROSS keeps the ids the cases had before to_center joined them
@pytest.mark.parametrize("use_roi,topology", [
    pytest.param(False, "cross", id="False"), pytest.param(True, "cross", id="True"),
    pytest.param(False, "to_center", id="to_center-False"),
    pytest.param(True, "to_center", id="to_center-True")])
def test_array_spans(rig, use_roi, topology):
    """CROSS (4 sources, the mean) and to_center (8 sources on the 3x3 rig,
    the mean of the 6 best; the refinement's hat blend) emit one list."""
    cams, images = rig
    cfg = ARRAY_CFG.override(**{"plane_sweep.topology": topology})

    def call():
        return array_depth_pipeline(images, cams, cfg, use_roi=use_roi, roi_mode="otsu")

    plain = call()
    out, spans, uncovered = profiled(call)
    want = ARRAY[:1] + ["svt.array.roi"] + ARRAY[1:] if use_roi else ARRAY
    assert [n for n, _, _ in spans] == want
    assert_flat_and_covering(spans, uncovered)
    assert_same(out, plain)


def test_stream_executor_spans(pair):
    left, right = pair
    frames = [torch.stack([left, right]).numpy() for _ in range(2)]

    def step(f):
        with record_function("test.step"):  # the test's own indexing
            left_dev, right_dev = f[0], f[1]
        return two_view_disparity(left_dev, right_dev, COST, SGM)

    def run():
        return list(StreamExecutor(step, depth=2, device="cpu").run(iter(frames)))

    outs, spans, uncovered = profiled(run)
    names = [n for n, _, _ in spans]
    stream = [n for n in names if n.startswith("svt.stream.")]
    # every frame pulled and copied, then the pull that finds the source empty
    assert stream == ["svt.stream.next", "svt.stream.copy"] * 2 + ["svt.stream.next"]
    assert names.count("svt.two_view.sgm") == 2
    assert {n for n in names if not n.startswith("svt.stream.")} == {
        f"svt.two_view.{s}" for s in TWO_VIEW["int16"]}
    assert_flat_and_covering(spans, uncovered)
    for out in outs:
        assert_same(out, two_view_disparity(left, right, COST, SGM))


def test_cascade_opens_no_span_around_its_passes(pair):
    left, right = pair
    _, spans, _ = profiled(lambda: cascade_two_view_disparity(
        left, right, CostConfig(num_disparities=16), SGM, coarse_factor=2,
        fine_disparities=8, band_step=4))
    assert [n for n, _, _ in spans].count("svt.two_view.sgm") == 2
    assert_flat_and_covering(spans)  # the cascade's own work between the passes is uncovered


def test_span_with_no_profiler_is_the_shared_null_context(pair, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or record_function(name))
    assert profiling.span("svt.two_view.cost") is profiling.span("svt.x")
    assert profiling.span("svt.x") is profiling._NO_SPAN
    two_view_disparity(*pair, COST, SGM)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("svt.x"):
            pass
    assert made == ["svt.x"]
