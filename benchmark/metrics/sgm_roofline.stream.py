"""K2/K3 (kernels named sgm_*) against its least time at the cell's shape, %."""

from benchmark import rooflines
from benchmark.readers import roofline_pct, two_view_shape


def read(run):
    h, w, D, cost_bytes = two_view_shape(run)
    paths = run.config["engine"]["sgm"]["num_paths"]
    return roofline_pct(run, rooflines.sgm_paths(h, w, D, cost_bytes, paths), "sgm_")
