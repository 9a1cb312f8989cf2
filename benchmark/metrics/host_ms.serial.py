"""Host ms a pair inside the two_view_disparity call (with the handover
copy) and the fetch of its maps, without the wait for the card: the
harness's spans bench.call and bench.fetch."""

from benchmark.readers import per_unit_ms


def read(run):
    if not run.trace.host_names:
        return None
    return per_unit_ms(run, run.trace.span_s("bench.call", "bench.fetch"))
