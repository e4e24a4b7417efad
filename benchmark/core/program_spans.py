"""Readings of the program's own spans in the device trace.

The port marks its phases with ``utils/benchmark.py::span`` (``replay.stage``,
``pipeline.window``, ``train.fetch``, ...).  While a profiler records, each
is a ``torch.profiler.record_function`` range: a ``user_annotation`` event of
the trace, on the profiler's clock, which ``DeviceTrace.collect`` keeps in
``run.dtrace.host`` (name, start us, duration us, thread) beside the kernels.
A span is taken by its exact name.  A program without the spans (a commit
before them) has none in the trace, and every function here then returns
None.

Idle card time is the traced part that the union of the kernels, copies and
memsets does not cover (``trace._union``, as ``DeviceTrace.busy_s`` takes
it): the gaps between them, and the stretches from the start of the traced
part to the first kernel and from the last kernel to its end, which
``device_idle_pct`` counts as idle too.  The traced part starts at the
trace's first event and lasts ``window_s``, the host clock's reading
between the profiler's start and its stop: a span still open when the
profiler stops (the ``train.fetch`` whose batch ends the traced steps) is
recorded up to the end of the profiler's own teardown, past the traced
part.
"""
from __future__ import annotations

from statistics import mean
from typing import Iterable, List, Optional, Tuple

from .readings import traced
from .trace import _union

Interval = Tuple[float, float]


def span_intervals(run, names: Iterable[str]) -> List[Interval]:
    """Start and end (us) of every span whose name is one of ``names``."""
    t = traced(run)
    if t is None:
        return []
    names = set(names)
    return [(s, s + d) for n, s, d, _ in t.host if n in names]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint stretches covering the same time."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_intervals(t) -> List[Interval]:
    """The stretches of the traced part in which the card ran nothing."""
    kernels = [(s, s + d) for _, s, d in t.kernels]
    if not kernels:
        return []
    _, gaps = _union(kernels)
    first_kernel = min(a for a, _ in kernels)
    start = min([first_kernel] + [s for _, s, _, _ in t.host])
    end = start + 1e6 * t.window_s
    stretches = [(start, first_kernel)] + gaps + [(max(b for _, b in kernels), end)]
    return [(a, min(b, end)) for a, b in stretches if min(b, end) > a]


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_pct(run, names: Iterable[str]) -> Optional[float]:
    """Idle card time inside the spans of ``names``, over the traced window
    (the host clock's ``window_s``, as ``device_idle_pct``), in %."""
    spans = span_intervals(run, names)
    if not spans:
        return None
    t = traced(run)
    inside = overlap(merged(spans), idle_intervals(t))
    return 100.0 * inside * 1e-6 / t.window_s


def span_mean_ms(run, name: str) -> Optional[float]:
    """Mean length of the spans named ``name`` in the traced part, in ms."""
    spans = span_intervals(run, [name])
    return 1e-3 * mean(b - a for a, b in spans) if spans else None
