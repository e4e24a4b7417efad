"""Idle card time inside the program's ``replay.stage`` spans
(``MappingReplay._stage``: pad, stack, pin and start the copies of a
window), over the traced part of the window, in %."""
from benchmark.core.program_spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, ["replay.stage"])
