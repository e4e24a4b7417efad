"""Mean host milliseconds of one staging call (``MappingReplay._stage``:
pad, stack, pin and start the copies of a window), the benchmark's own span
around it, over the whole window."""
from benchmark.core.readings import span_ms


def read(run):
    return span_ms(run, "stage")
