"""Card-idle ms a pair covered by the streaming layer's spans
(svt.stream.*): the card waiting for the next frame to be pulled and copied."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "svt.stream.")
