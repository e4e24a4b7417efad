"""Share of the traced training steps in which no kernel, copy or memset
ran on the card (the union of their intervals), in %."""
from benchmark.core.readings import idle_pct


def read(run):
    return idle_pct(run)
