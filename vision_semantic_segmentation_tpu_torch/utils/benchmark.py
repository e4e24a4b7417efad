"""Profiling helpers: the program's spans, a profiler trace, cProfile.

Port of ``vision_semantic_segmentation_tpu/utils/benchmark.py`` (ref
src/network/core/utils/benchmark.py:4-25 and the cProfile decorator of
src/utils/utils.py:17-32), with the JAX package's timers replaced by spans
on the profiler's clock.

PyTorch returns from a CUDA op before the card has run it, so a host clock
around a call measures the enqueue.  :func:`span` marks a phase of the
program as a ``torch.profiler.record_function`` range, which lands in the
same trace as the card's kernels, so the trace shows which phase the host
was in while the card waited; with no profiler running it does nothing.
:func:`trace` records a ``torch.profiler`` trace and writes it for
Chrome's trace viewer (the JAX package wraps ``jax.profiler``).
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
from typing import Callable, ContextManager, Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["span", "profile", "trace"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A named range of the program on the profiler's clock.

    While a profiler records on this thread, ``torch.profiler.
    record_function(name)``: a ``user_annotation`` event in the trace,
    nested in the spans open around it.  Otherwise one shared no-op
    context, so a span costs one flag check when nothing records (entering
    ``record_function`` without a profiler costs about a hundred times
    more).  Names are dotted, layer first (``replay.stage``,
    ``pipeline.window``, ``train.step``).
    """
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


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
