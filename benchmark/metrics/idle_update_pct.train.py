"""Idle card time inside the program's ``train.update`` spans (the
optimizer's and the schedule's step), over the traced training steps, in %."""
from benchmark.core.program_spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, ["train.update"])
