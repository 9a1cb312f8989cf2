"""K8 (kernels named plane_sweep*) against its least time at the cell's
shape, %."""

from benchmark import rooflines
from benchmark.readers import array_shape, roofline_pct


def read(run):
    h, w, D, n_src = array_shape(run)
    return roofline_pct(run, rooflines.plane_sweep(h, w, D, n_src), "plane_sweep")
