"""Share of the traced window with no kernel, copy or fill on the card, %."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
