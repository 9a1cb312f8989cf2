"""The refinement's kernels (csrc/refine.cu, named refine_*) against their
least time at the cell's shape, %; None where the program has none.

A pass's least work, as ``scripts/perf_refine.py::bound_ms`` counts it: the
float32 reference, disparity and views and the byte mask read once, the
three float32 outputs and the byte validity written once; 30 operations a
candidate offset, view and pixel for the data term (in-view test, two
stack samples, their blend, the difference, the sum). It leaves out the
window's box sums (two running sums a candidate and pixel, independent of
the views) and the selection. ``rooflines.py`` is frozen, so the count lives
here; the peaks are its ``PEAKS``.
"""

from benchmark import rooflines
from benchmark.readers import array_shape, roofline_pct

OPS_PER_VIEW_TERM = 30


def work(h: int, w: int, views: int, radius: int):
    """(bytes, operations) of one pass over (h, w) with `views` views."""
    n = h * w
    nbytes = n * (4 * (2 + views) + 1) + n * (3 * 4 + 1)
    return nbytes, (2 * radius + 1) * views * n * OPS_PER_VIEW_TERM


def read(run):
    h, w, _, views = array_shape(run)
    refine = run.config["engine"]["refine"]
    nbytes, ops = work(h, w, views, refine["radius"])
    return roofline_pct(run, (refine["iterations"] * nbytes, refine["iterations"] * ops),
                        "refine_")
