"""Meters and metric logging.

Port of ``vision_semantic_segmentation_tpu/train/meters.py`` (ref
core/utils/metric.py:13-193): windowed + global AverageMeter, a MeterLogger
dict with metric binding, and the GenericMetric ABC.  One device, so the
cross-process hooks are no-ops.  Tensors are read back to the host.
"""
from __future__ import annotations

import numbers
from collections import defaultdict, deque
from typing import Dict

import numpy as np
import torch


class GenericMetric:
    """Metric ABC (ref metric.py:13-50)."""

    def evaluate(self, preds, labels):
        raise NotImplementedError

    def synchronize_between_processes(self):
        raise NotImplementedError

    @property
    def global_avg(self):
        raise NotImplementedError

    def __str__(self):
        return f"{self.global_avg:.4f}"

    @property
    def summary_str(self):
        return str(self)


class AverageMeter:
    """Windowed + global average tracker (ref metric.py:53-123)."""

    def __init__(self, window_size: int = 20):
        self.value_queue = deque(maxlen=window_size)
        self.count_queue = deque(maxlen=window_size)
        self.sum = 0.0
        self.count = 0

    def update(self, value, count=1):
        if not (isinstance(value, numbers.Number) or np.ndim(value) == 1):
            raise ValueError(f"a number or a 1-D array expected, got {value!r}")
        if not (isinstance(count, numbers.Number) or np.ndim(count) == 1):
            raise ValueError(f"a number or a 1-D array expected, got {count!r}")
        self.value_queue.append(value)
        self.count_queue.append(count)
        self.sum += float(np.sum(value))
        self.count += int(np.sum(count))

    def synchronize_between_processes(self):
        return

    @property
    def avg(self) -> float:
        count_sum = np.sum(self.count_queue)
        return float(np.sum(self.value_queue) / count_sum) if count_sum != 0 else float("nan")

    @property
    def global_avg(self) -> float:
        return self.sum / self.count if self.count != 0 else float("nan")

    def reset(self):
        self.value_queue.clear()
        self.count_queue.clear()
        self.sum = 0.0
        self.count = 0

    def __str__(self):
        return f"{self.avg:.4f} ({self.global_avg:.4f})"

    @property
    def summary_str(self):
        return f"{self.global_avg:.4f}"


class MeterLogger:
    """Dict of meters with uniform update/printing (ref metric.py:126-193)."""

    def __init__(self, delimiter: str = " "):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, np.ndarray) or hasattr(v, "shape"):
                arr = np.asarray(v)
                self.meters[k].update(float(arr.sum()), int(arr.size))
            elif isinstance(v, numbers.Number):
                self.meters[k].update(v, 1)
            else:
                raise NotImplementedError(f"Cannot meter type {type(v)}")

    def bind(self, metric) -> None:
        self.meters[type(metric).__name__] = metric

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    @property
    def summary_str(self):
        return self.delimiter.join(f"{k}: {m.summary_str}" for k, m in self.meters.items())

    def reset(self):
        for meter in self.meters.values():
            meter.reset()
