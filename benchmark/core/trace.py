"""Spans on the host clock, and the device trace of a short steady part of
a window.

:class:`Spans` times named regions of the benchmark's own calls into the
program (host clock, in seconds); in a traced run each region is also a
``torch.profiler.record_function`` range, so the trace's idle gaps can be
named by what the host was doing.

:class:`DeviceTrace` runs ``torch.profiler`` (CPU and CUDA activities)
between :meth:`start` and :meth:`stop`, each after a device synchronise,
and reduces the exported trace to kernel intervals: the busy time is the
length of their union (overlapping streams count once), the window the host
clock between start and stop.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.times[name].append(time.perf_counter() - t0)


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the gaps between covered stretches."""
    total, gaps = 0.0, []
    end = None
    for a, b in sorted(intervals):
        if end is None:
            total, end = b - a, b
        elif a > end:
            gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


class DeviceTrace:
    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.prof = None  # a profiler, from start until collected
        self.active = False
        self.window_s = 0.0
        self.kernels: List[Tuple[str, float, float]] = []  # name, start us, duration us
        self.host: List[Tuple[str, float, float, int]] = []  # name, start us, duration us, tid
        self._t0 = 0.0
        self.launches_before: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.units = 0  # units of work (windows, steps) the trace covers

    def start(self, launches: Optional[Dict[str, int]] = None) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True
        self.launches_before = dict(launches or {})
        self._t0 = time.perf_counter()

    def stop(self, launches: Optional[Dict[str, int]] = None) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.launches = {k: v - self.launches_before.get(k, 0) for k, v in (launches or {}).items()}
        self.prof.stop()
        self.active = False

    def collect(self) -> None:
        """Reduce the stopped profiler's trace (after the window: exporting
        takes seconds)."""
        if self.prof is None:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        path.unlink()
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.kernels.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
            elif cat in ("user_annotation", "cpu_op", "python_function"):
                self.host.append((e.get("name", ""), float(e["ts"]), float(e["dur"]),
                                  int(e.get("tid", 0))))
        self.prof = None

    @property
    def busy_s(self) -> float:
        return _union([(s, s + d) for _, s, d in self.kernels])[0] * 1e-6

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Summed device seconds and count of the kernels whose name holds ``pattern``."""
        hits = [d for n, _, d in self.kernels if pattern in n]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, _, d in self.kernels:
            by[n[:160]] += d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest gaps between kernels, named by the innermost host range
        (the benchmark's spans first) that covers the gap's middle."""
        _, gaps = _union([(s, s + d) for _, s, d in self.kernels])
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) / 2
            around = [(d, n) for n, s, d, _ in self.host if s <= mid <= s + d]
            name = min(around)[1] if around else "no host range"
            out.append([name[:160], (b - a) * 1e-6])
        return out
