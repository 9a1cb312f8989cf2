"""The frozen bytes and operations give the bound column of the kernel
table in PERF.md (ms, to its four places)."""

from __future__ import annotations

import pytest

from benchmark import rooflines

BENCH = (540, 768, 64)


@pytest.mark.parametrize("kernel,work,ms,by", [
    ("K1 int8 540x768x64", rooflines.cost_volume(*BENCH, (7, 9), 1), 0.0089, "bytes"),
    ("K1 D=256", rooflines.cost_volume(540, 768, 256, (7, 9), 1), 0.0327, "bytes"),
    ("K2/K3 540x768x64", rooflines.sgm_paths(*BENCH, 1), 0.0254, "operations"),
    ("K5 fused into K4", rooflines.extract_maps(*BENCH, lr=True), 0.0175, "bytes"),
    ("K4 D=256 + LR", rooflines.extract_maps(540, 768, 256, lr=True), 0.0650, "bytes"),
    ("K4 270x360x128", rooflines.extract_maps(270, 360, 128, lr=False), 0.0078, "bytes"),
    ("K8 CROSS", rooflines.plane_sweep(270, 360, 128, 4), 0.0446, "operations"),
])
def test_bound_column(kernel, work, ms, by):
    got, got_by = rooflines.bound_ms(*work)
    assert round(got, 4) == ms and got_by == by, kernel


def test_cells_bounds():
    """The bounds the cells' readers use (KITTI at D=256, int16 costs)."""
    assert round(rooflines.bound_ms(*rooflines.sgm_paths(375, 1242, 256, 2))[0], 4) == 0.1429
    assert round(rooflines.bound_ms(*rooflines.extract_maps(375, 1242, 256, True))[0], 4) == 0.0730
