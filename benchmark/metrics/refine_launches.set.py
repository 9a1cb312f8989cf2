"""Kernel launches a frame-set issued inside the refinement's spans
(svt.refine.*): the refinement's part of launches.set."""

from benchmark.spans import launches


def read(run):
    return launches(run, "svt.refine.")
