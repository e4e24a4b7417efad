"""Idle card time inside the program's ``pipeline.window`` spans
(``FusedFramePipeline.run_window``: each frame's forward, projection and
map update queued), over the traced part of the window, in %."""
from benchmark.core.program_spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, ["pipeline.window"])
