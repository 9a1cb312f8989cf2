"""The harness on the CPU path at a tiny size: a whole run of every cell
but the look for a card, the result line's keys, a cell (with its own
pipeline kind, loop and reference) added as files, and the faults the check
has to catch."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import tiny_bench

CELLS = ("kitti_stream", "kitti_latency", "array_cross_live")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


@pytest.fixture
def bench(tmp_path):
    return tiny_bench(tmp_path)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(bench, workload):
    spec, base = bench
    res = harness.run_cell(spec, workload, 2**31 + 11, 0.3, False, device="cpu", base=base)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] and all(v["value"] == 0 for v in res["checks"].values())
    assert "setup_s" in res["metrics"]
    host_clock = {"kitti_stream": "pair_ms", "kitti_latency": "pair_p95_ms"}
    if workload in host_clock:
        assert res["metrics"][host_clock[workload]]["value"] > 0


def test_result_line_keys(bench, capsys):
    spec, base = bench
    res = harness.run_cell(spec, "kitti_latency", 5, 0.2, False, device="cpu", base=base)
    harness.emit(res)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert set(last) <= LINE_KEYS and {"correct", "attempted", "failed", "metrics",
                                        "device"} <= set(last)
    assert list(last)[-1] == "checks"  # the compared numbers come last
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k in last["checks"]:
        assert f"check {k}:" in out.err
    assert out.err.strip().splitlines()[-1].startswith("check correct:")


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "kitti_stream", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_cell_added_as_files(bench):
    """A new configuration, traffic and metric are files and entries only."""
    spec, base = bench
    cfg = json.loads((base / "kitti2015_sgm.json").read_text())
    cfg["engine"]["cost"]["dtype"] = "int8"
    (base / "tiny_int8.json").write_text(json.dumps(cfg))
    (base / "traffic" / "two_pairs.json").write_text(json.dumps(
        {"loop": "serial", "pool": 2, "warmup_units": 1, "trace_seconds": 1, "check": 1}))
    (base / "metrics" / "pairs_done.py").write_text("def read(run):\n    return run.units\n")
    spec["configs"].append({"name": "tiny_int8", "source": "test", "reduced": [], "why": "test",
                            "file": str(base / "tiny_int8.json")})
    spec["workloads"].append({"name": "tiny", "config": "tiny_int8", "traffic": "two_pairs",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "pairs_done", "unit": "count", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["tiny"]})
    res = harness.run_cell(spec, "tiny", 3, 0.2, False, device="cpu", base=base)
    assert res["correct"]
    assert res["metrics"]["pairs_done"]["value"] == res["attempted"] > 0


# a pipeline kind, a loop and a reference of a throwaway cell: a 3x3 box
# sum of 8-bit images, handed over one at a time
KIND = """
import numpy as np
from types import SimpleNamespace
from benchmark.pipelines import Pipeline


class Kind(Pipeline):
    fetch = ("box",)

    def load(self):
        pass

    def make_pool(self, seed, n):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 256, (1, 9, 12), dtype=np.uint8) for _ in range(n)]

    def call(self, frame_dev):
        x = frame_dev.to(self.torch.float32)[None]
        ones = self.torch.ones((1, 1, 3, 3), dtype=x.dtype, device=x.device)
        return SimpleNamespace(box=self.torch.nn.functional.conv2d(x, ones, padding=1)[0, 0])

    def maps(self, out):
        return {"box": out.box}

    def reference(self, frame, control=False):
        return self.ref.box(frame)
"""
LOOP = """
import time
from benchmark import loops


class Loop(loops.Loop):
    def window(self, seconds, slots, spans):
        P, samples, n = len(self.pool), [None] * self.k, 0
        t0 = time.perf_counter()
        while n < len(slots) and time.perf_counter() < t0 + seconds:
            out = self.pipe.call(self.pipe.to_device(self.torch.from_numpy(self.pool[n % P])))
            if slots[n] >= 0:
                samples[slots[n]] = (n % P, out, None)
            n += 1
        return loops.Window(n, time.perf_counter() - t0, None, samples)
"""
REFERENCE = """
import numpy as np
import torch


def box(frame):
    p = np.pad(frame[0].astype(np.float32), 1)
    h, w = frame.shape[1:]
    total = sum(p[i:i + h, j:j + w] for i in range(3) for j in range(3))
    return {"box": torch.from_numpy(total + OFF_BY)}
"""


@pytest.mark.parametrize("off_by", [0, 1])
def test_loop_and_kind_added_as_files(bench, off_by):
    """A new pipeline kind, loop and reference are files and entries only;
    the configuration's ``reference`` decides what checks it."""
    spec, base = bench
    (base / "pipelines" / "box.py").write_text(KIND)
    (base / "loops" / "one_by_one.py").write_text(LOOP)
    (base / "box_ref.py").write_text(REFERENCE.replace("OFF_BY", f"np.float32({off_by})"))
    (base / "box.json").write_text(json.dumps(
        {"pipeline": "box", "reference": str(base / "box_ref.py"), "engine": {},
         "limits": {"box_px": 0}}))
    (base / "traffic" / "frames.json").write_text(json.dumps(
        {"loop": "one_by_one", "pool": 3, "warmup_units": 2, "trace_seconds": 1, "check": 2}))
    spec["configs"].append({"name": "box", "source": "test", "reduced": [], "why": "test",
                            "file": str(base / "box.json")})
    spec["workloads"].append({"name": "box_frames", "config": "box", "traffic": "frames",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "pair_ms", "unit": "ms", "better": "lower",
                               "bound": 0.1, "source": "host_clock", "workloads": ["box_frames"]})
    res = harness.run_cell(spec, "box_frames", 2**31 + 17, 0.2, False, device="cpu", base=base)
    assert res["attempted"] > 0 and res["metrics"]["pair_ms"]["value"] > 0
    assert res["correct"] is (off_by == 0)
    assert res["checks"]["box_px"]["value"] == (0 if off_by == 0 else 2 * 9 * 12)


def _alter_one(t):
    t = t.clone()
    t.view(-1)[t.numel() // 2] += 1
    return t


def _two_view_answer_altered(monkeypatch):
    from stereovisionarray_tpu_torch.models import two_view

    real = two_view.extract_maps

    def altered(*a, **k):
        m = real(*a, **k)
        return m._replace(disparity=_alter_one(m.disparity))

    monkeypatch.setattr(two_view, "extract_maps", altered)


def _sgm_unchanged(monkeypatch):
    """The SGM step hands its input on: the costs, not their path sum."""
    from stereovisionarray_tpu_torch.models import two_view

    monkeypatch.setattr(two_view, "sgm_aggregate_paths",
                        lambda vol, *a, **k: vol.to(torch.int16))


def _refinement_unchanged(monkeypatch):
    from stereovisionarray_tpu_torch.models import array_pipeline

    real = array_pipeline.multiview_refine

    def unchanged(ref, aux, bl, disparity, **k):
        return real(ref, aux, bl, disparity, **k)._replace(disparity=disparity)

    monkeypatch.setattr(array_pipeline, "multiview_refine", unchanged)


def _refinement_answer_altered(monkeypatch):
    from stereovisionarray_tpu_torch.models import array_pipeline

    real = array_pipeline.multiview_refine

    def altered(*a, **k):
        out = real(*a, **k)
        return out._replace(disparity=_alter_one(out.disparity))

    monkeypatch.setattr(array_pipeline, "multiview_refine", altered)


@pytest.mark.parametrize("workload,fault", [
    ("kitti_stream", _two_view_answer_altered),
    ("kitti_latency", _two_view_answer_altered),
    ("kitti_stream", _sgm_unchanged),
    ("array_cross_live", _refinement_unchanged),
    ("array_cross_live", _refinement_answer_altered),
])
def test_fault_is_caught(bench, monkeypatch, workload, fault):
    spec, base = bench
    fault(monkeypatch)
    res = harness.run_cell(spec, workload, 2**31 + 13, 0.2, False, device="cpu", base=base)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
