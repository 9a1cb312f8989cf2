"""The card's own time a frame-set, ms: the union of every kernel, copy and
fill the window's sets ran on the device (never an idle gap), over the sets."""

from benchmark.readers import per_unit_ms


def read(run):
    if not len(run.trace.dev_start):
        return None
    return per_unit_ms(run, run.trace.busy_s())
