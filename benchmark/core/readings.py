"""Helpers the per-layer metric readers share.

A reader returns None where its run has nothing to read (no trace, no
launch of its kernel in the traced part), and the harness then leaves the
metric out of the result line.
"""
from __future__ import annotations

from statistics import mean
from typing import Optional

from ..counts.kernels import roofline_pct

# a launch counter of the program (``ops/kernels``) -> the CUDA kernel name it runs
KERNEL_SYMBOLS = {
    "aspp_depthwise3x3_multi": "aspp_phase_kernel",
    "depthwise3x3_dilated": "phase_walk_kernel",
    "evidence_fold_add": "fold_",
}


def span_ms(run, name: str) -> Optional[float]:
    times = run.spans.times.get(name)
    return 1e3 * mean(times) if times else None


def traced(run):
    t = run.dtrace
    return t if t is not None and t.window_s > 0 else None


def idle_pct(run) -> Optional[float]:
    t = traced(run)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_roofline(run, counter: str, bytes_per_launch: int) -> Optional[float]:
    """A kernel's share of its byte roofline over the traced part: its
    launches' bytes over the card's bandwidth, over the device seconds of
    its CUDA kernels."""
    t = traced(run)
    if t is None:
        return None
    launches = t.launches.get(counter, 0)
    seconds, count = t.kernel_seconds(KERNEL_SYMBOLS[counter])
    if not launches or not count or seconds <= 0:
        return None
    return roofline_pct(launches * bytes_per_launch, seconds)


def traced_work(run) -> Optional[float]:
    """Frames or images of the traced part: its units times a unit's work."""
    t = traced(run)
    if t is None or not t.units:
        return None
    return t.units * float(run.window["unit_work"])


ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
