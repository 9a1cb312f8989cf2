"""The span arithmetic (``benchmark/spans.py``) on hand-built traces: the
idle gaps the program's spans cover, the launches issued inside them, None
where the window holds no span; and the four readers of the spans, found
by name as the harness finds them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import parts, spans
from benchmark.trace import Trace

US = 1000  # ns

# the card busy over [0, 10), [20, 30), [50, 60) us: gaps [10, 20) and [30, 50)
DEVICE = [("k0", 0, 10 * US), ("k1", 20 * US, 10 * US), ("k2", 50 * US, 10 * US)]

READERS = {"pipeline_host_ms.serial": "svt.two_view.",
           "pipeline_idle_ms.serial": "svt.two_view.",
           "stream_idle_ms.stream": "svt.stream.",
           "refine_launches.set": "svt.refine."}


def host(*events):
    return [(n, s * US, e * US) for n, s, e in events]


def run_of(trace, units=1):
    return SimpleNamespace(units=units, trace=trace, window_s=1.0, latencies=None,
                           setup_s=0.0, config={}, traffic={}, port_kernels=())


def test_idle_covered_by_spans_partly_and_back_to_back():
    trace = Trace(DEVICE, host(
        ("svt.x.a", 12, 18),  # inside the first gap: 6 us
        ("svt.x.b", 25, 35),  # half over the card's work: 5 us of the second gap
        ("svt.x.c", 35, 45),  # back to back with b: 10 us
        ("svt.x.d", -5, 0),  # before the first activity: no gap
        ("svt.y.e", 45, 50),  # another family
        ("bench.call", 10, 50),  # the harness's span, over both gaps
    ))
    assert spans.idle_covered_s(trace, "svt.x.") == pytest.approx(21e-6)
    assert spans.idle_covered_s(trace, "svt.y.") == pytest.approx(5e-6)
    assert spans.idle_covered_s(trace, "svt.") == pytest.approx(26e-6)


def test_overlapping_spans_are_counted_once():
    trace = Trace(DEVICE, host(("svt.x.a", 32, 40), ("svt.x.b", 36, 44)))
    assert spans.union(trace, "svt.x.").tolist() == [[32 * US, 44 * US]]
    assert spans.idle_covered_s(trace, "svt.x.") == pytest.approx(12e-6)


def test_launches_counted_only_inside_spans():
    trace = Trace(DEVICE, host(
        ("svt.refine.costs", 10, 20), ("svt.refine.select", 20, 25),
        ("cudaLaunchKernel", 10, 11),  # at the span's start: inside
        ("cudaLaunchKernelExC", 19, 20),  # inside
        ("cuLaunchKernel", 21, 22),  # the low-level API's launch, inside the next span
        ("cudaLaunchKernel", 25, 26),  # at the last span's end: outside
        ("cudaLaunchKernel", 5, 6),  # before
        ("cudaMemcpyAsync", 12, 13),  # a copy, not a launch
        ("aten::mul", 14, 16),
    ))
    assert spans.launches_in(trace, "svt.refine.") == 3
    assert spans.launches_in(trace, "svt.sweep.") == 0


def test_per_unit_values_and_none_without_spans():
    trace = Trace(DEVICE, host(("svt.two_view.cost", 12, 18), ("svt.two_view.sgm", 18, 19),
                               ("cudaLaunchKernel", 13, 14)))
    run = run_of(trace, units=2)
    assert spans.host_ms(run, "svt.two_view.") == pytest.approx(7e-3 / 2)
    assert spans.idle_ms(run, "svt.two_view.") == pytest.approx(7e-3 / 2)
    assert spans.launches(run, "svt.two_view.") == 0.5
    # spans that cover no idle time read 0, not None
    busy_only = run_of(Trace(DEVICE, host(("svt.stream.copy", 2, 8))))
    assert spans.idle_ms(busy_only, "svt.stream.") == 0.0
    # no svt.* event: nothing to read
    harness_only = run_of(Trace(DEVICE, host(("bench.call", 10, 50),
                                             ("cudaLaunchKernel", 12, 13))))
    for fn in (spans.host_ms, spans.idle_ms, spans.launches):
        assert fn(harness_only, "svt.two_view.") is None
    assert spans.host_ms(run_of(trace, units=0), "svt.two_view.") is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_found_by_name(name):
    read = parts.find(parts.HERE, "metrics", name, "read")
    assert read(run_of(Trace([]))) is None
    assert read(run_of(Trace(DEVICE, host(("bench.call", 10, 50))))) is None
    prefix = READERS[name]
    trace = Trace(DEVICE, host((prefix + "stage", 12, 18), ("cudaLaunchKernel", 13, 14)))
    want = {"pipeline_host_ms.serial": 6e-3, "pipeline_idle_ms.serial": 6e-3,
            "stream_idle_ms.stream": 6e-3, "refine_launches.set": 1.0}[name]
    assert read(run_of(trace)) == pytest.approx(want)
