"""The whole window over the pairs it completed, ms (host clock)."""

from benchmark.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, run.window_s)
