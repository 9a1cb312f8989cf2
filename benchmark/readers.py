"""Arithmetic the metric readers share. A reader (``metrics/<name>.py``)
takes the run (``config``, ``traffic``, ``units``, ``window_s``,
``latencies``, ``setup_s``, ``trace``, ``port_kernels``) and returns a
number, or None where the run holds nothing to read: a share of a roofline
is never reported as 0."""

from __future__ import annotations

from typing import Optional

from benchmark import rooflines
from benchmark.reference.array import reference_and_sources
from benchmark.reference.two_view import cost_dtype

ELEMENT_BYTES = {"int8": 1, "int16": 2, "float32": 4}


def per_unit_ms(run, seconds: float) -> Optional[float]:
    return 1e3 * seconds / run.units if run.units and seconds > 0 else None


def kernel_ms(run, *patterns: str) -> Optional[float]:
    """Device ms a unit of the kernels whose names contain `patterns`."""
    return per_unit_ms(run, run.trace.device_s(run.trace.kernel_mask(*patterns)))


def roofline_pct(run, bound, *patterns: str) -> Optional[float]:
    """100 x the kernel's least ms over its measured device ms a unit."""
    ms = kernel_ms(run, *patterns)
    return None if ms is None else 100.0 * rooflines.bound_ms(*bound)[0] / ms


def idle_pct(run) -> Optional[float]:
    if not run.units or not len(run.trace.dev_start) or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)


def two_view_shape(run):
    """(H, W, D, cost bytes) of a two-view configuration."""
    h, w = run.config["image"]
    cost = run.config["engine"]["cost"]
    return h, w, cost["num_disparities"], ELEMENT_BYTES[cost_dtype(cost)]


def array_shape(run):
    """(H, W, planes, sources) of an array configuration."""
    e = run.config["engine"]
    h, w = run.config["rig"]["resolution"]
    _, src = reference_and_sources(e["camera"]["rows"], e["camera"]["cols"],
                                   e["plane_sweep"]["topology"])
    return h, w, e["plane_sweep"]["num_planes"], len(src)
