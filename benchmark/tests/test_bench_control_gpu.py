"""On the card: the program reads 0 on every compared number over several
seeds, and the control (the step below the configuration's precision) fails
one of them on every seed, at a size a test run holds. Run with
``python -m pytest -m gpu benchmark/tests``; skips without a card."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests.helpers import ON_CARD, tiny_bench

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", ["kitti_stream", "kitti_latency", "array_cross_live"])
def test_sound_reads_zero_and_control_fails(card, tmp_path, workload):
    spec, base = tiny_bench(tmp_path, sizes=ON_CARD)
    rows = list(control.readings(torch, workload, [1, 2, 2**31 + 3], 0.5, base=base, spec=spec))
    for row in rows:
        assert all(v["value"] == 0 for v in row["sound"].values()), row
        assert any(v["value"] > v["limit"] for v in row["control"].values()), row
