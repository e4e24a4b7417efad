"""Timing and profiling helpers.

Port of ``vision_semantic_segmentation_tpu/utils/benchmark.py`` (ref
src/network/core/utils/benchmark.py:4-25 and the cProfile decorator of
src/utils/utils.py:17-32).

PyTorch returns from a CUDA op before the card has run it, so a host clock
around a call measures the enqueue.  :func:`device_timer` and
``StageTimer.stage(block_on=...)`` synchronise the current CUDA stream of
each CUDA tensor they are given before reading the clock (the JAX package
blocks on its arrays); a CPU tensor needs nothing.  :func:`trace` records a
``torch.profiler`` trace and writes it for Chrome's trace viewer (the JAX
package wraps ``jax.profiler``).
"""
from __future__ import annotations

import contextlib
import cProfile
import functools
import io
import os
import os.path as osp
import pstats
import tempfile
import time
from typing import Any, Callable, Optional

import torch

__all__ = ["timer", "device_timer", "profile", "trace", "StageTimer"]


def _block(obj: Any) -> None:
    """Wait for the current stream of the device of every CUDA tensor in ``obj``
    (a tensor, or lists, tuples and dict values of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.current_stream(obj.device).synchronize()
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _block(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            _block(x)


def timer(func: Callable) -> Callable:
    """Decorator printing the wall-clock time of each call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        print(f"{func.__name__} took {time.perf_counter() - start:.4f}s")
        return result

    return wrapper


def device_timer(func: Callable) -> Callable:
    """Like :func:`timer`, after the result's CUDA work has finished."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        _block(result)
        print(f"{func.__name__} took {time.perf_counter() - start:.4f}s (device)")
        return result

    return wrapper


def profile(func: Callable) -> Callable:
    """cProfile decorator printing the top 10% cumulative entries."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        pr = cProfile.Profile()
        pr.enable()
        result = func(*args, **kwargs)
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(0.1)
        print(s.getvalue())
        return result

    return wrapper


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a region with ``torch.profiler`` (host, and the card when
    there is one) and write ``<log_dir>/trace.json`` in Chrome's trace
    format; ``log_dir`` defaults to ``torch-trace`` in the temporary
    directory.  Yields the profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    log_dir = log_dir or osp.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock per named pipeline stage (host side)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - start
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: total {total:.4f}s over {n} calls ({total / n:.5f}s/call)")
        return "\n".join(lines)
