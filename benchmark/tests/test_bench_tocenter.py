"""The port's default array deployment (``array5x5_tocenter``: 24 sources,
the mean of the 6 best, the refinement's hat blend over 24 views) as a
cell: a whole CPU run at a tiny size reads 0 on every map, and the count
behind ``refine_roofline.set`` gives row R's bounds in PERF.md."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, parts, rooflines
from benchmark.tests.helpers import ON_CARD, tiny_bench
from benchmark.trace import Trace

REFINE_ROOFLINE = parts.load_module(harness.HERE / "metrics" / "refine_roofline.set.py")


def test_cell_runs_and_is_correct(tmp_path):
    spec, base = tiny_bench(tmp_path)
    res = harness.run_cell(spec, "array_tocenter_live", 2**31 + 11, 0.3, False, device="cpu",
                           base=base)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] and all(v["value"] == 0 for v in res["checks"].values())
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("config,views,ms", [("array5x5_cross", 4, 0.0019),
                                             ("array5x5_tocenter", 24, 0.0115)])
def test_refine_bound_is_row_r(config, views, ms):
    """Row R's bound column: operations bound both passes at 270x360."""
    cfg = harness.load_json(harness.ROOT / f"benchmark/configs/{config}.json")
    radius = cfg["engine"]["refine"]["radius"]
    got, by = rooflines.bound_ms(*REFINE_ROOFLINE.work(270, 360, views, radius))
    assert (round(got, 4), by) == (ms, "operations")
    # the reader takes the views from the topology: 1 us of refine_* a set
    # reads the bound over 1 us
    run = SimpleNamespace(config=cfg, units=1, trace=Trace([("refine_rows_kernel", 0, 1000)]))
    assert REFINE_ROOFLINE.read(run) == pytest.approx(100.0 * got / 1e-3)
    run.trace = Trace([("plane_sweep_fast_kernel", 0, 1000)])
    assert REFINE_ROOFLINE.read(run) is None


@pytest.mark.gpu
def test_sound_reads_zero_and_control_fails_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, base = tiny_bench(tmp_path, sizes=ON_CARD)
    rows = list(control.readings(torch, "array_tocenter_live", [1, 2**31 + 3], 0.5, base=base,
                                 spec=spec))
    for row in rows:
        assert all(v["value"] == 0 for v in row["sound"].values()), row
        assert any(v["value"] > v["limit"] for v in row["control"].values()), row
