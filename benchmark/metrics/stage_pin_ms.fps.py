"""Mean host milliseconds of the program's ``replay.stage.pin`` spans (the
window's stacked arrays copied into pinned host memory) in the traced part
of the window."""
from benchmark.core.program_spans import span_mean_ms


def read(run):
    return span_mean_ms(run, "replay.stage.pin")
