"""Card-idle ms a pair covered by the pipeline's stage spans
(svt.two_view.*): the card waiting on the pipeline's own host code."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "svt.two_view.")
