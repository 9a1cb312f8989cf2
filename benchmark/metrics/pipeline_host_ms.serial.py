"""Host ms a pair inside the pipeline's own stage spans (svt.two_view.*):
the in-program part of host_ms.serial, without the harness's handover copy
and fetch."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "svt.two_view.")
