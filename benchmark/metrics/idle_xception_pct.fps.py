"""Idle card time while the host is inside the Xception-65 backbone's spans
(``models/xception.py::Xception65.forward``: ``xception.entry``,
``xception.middle``, ``xception.exit``), over the traced part of the
window, in %."""
from benchmark.core.program_spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, ["xception.entry", "xception.middle", "xception.exit"])
