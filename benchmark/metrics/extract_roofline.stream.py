"""K4 with K5's fused check (kernels named extract_maps*) against its least
time at the cell's shape, %."""

from benchmark import rooflines
from benchmark.readers import roofline_pct, two_view_shape


def read(run):
    h, w, D, _ = two_view_shape(run)
    lr = run.config["engine"]["sgm"]["lr_max_diff"] > 0
    return roofline_pct(run, rooflines.extract_maps(h, w, D, lr), "extract_maps")
