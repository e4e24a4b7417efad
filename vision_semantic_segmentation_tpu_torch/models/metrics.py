"""Segmentation metrics: mean IoU by confusion-matrix accumulation.

Port of ``vision_semantic_segmentation_tpu/models/metrics.py`` (ref
models/metrics.py:9-80).  The per-batch update runs on the tensors' device
as a histogram of truth * C + prediction (``torch.histc`` with a fixed
range, which needs no host sync, where ``bincount`` reads the maximum back;
the JAX package takes a one-hot matmul because scatters serialise on the
TPU).  The running matrix is float64 on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_update(preds: torch.Tensor, labels: torch.Tensor,
                            num_class: int) -> torch.Tensor:
    """Per-batch (C, C) confusion counts (f32); rows = truth, cols = prediction.

    Labels outside [0, num_class) are ignored (the reference's masking of
    the 255 boundary label).

    Args:
        preds: (N, C, ...) logits, argmax'd over axis 1, or (N, ...)
            integer predictions.
        labels: (N, ...) integer ground truth.
    """
    if preds.ndim == labels.ndim + 1:
        preds = preds.argmax(1)
    preds = preds.reshape(-1).long()
    labels = labels.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_class)
    cells = num_class * num_class
    # ignored pixels go to one extra bin, dropped after; counts stay exact
    # in f32 up to 2**24 a cell
    index = torch.where(valid, labels * num_class + preds, torch.full_like(labels, cells))
    counts = torch.histc(index.float(), bins=cells + 1, min=0, max=cells + 1)
    return counts[:cells].reshape(num_class, num_class)


def miou_from_confusion(cm) -> float:
    """nanmean of per-class IoU (ref metrics.py:72-80)."""
    cm = np.asarray(torch.as_tensor(cm).cpu(), dtype=np.float64)
    intersection = np.diag(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - intersection
    iou = np.divide(intersection, union, out=np.full(union.shape, np.nan), where=union > 0)
    return float(np.nanmean(iou))


class MeanIOU:
    """Stateful accumulator with the reference's API surface.

    ``evaluate`` accepts NCHW logits (or integer predictions) and integer
    labels; the counts come back once per call and add to a float64 matrix.
    """

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)

    def reset(self) -> None:
        self.confusion_matrix[:] = 0

    def evaluate(self, preds: torch.Tensor, labels: torch.Tensor) -> None:
        self.merge(confusion_matrix_update(preds, labels, self.num_class))

    def merge(self, cm) -> None:
        """Fold in a confusion matrix computed elsewhere (e.g. by a train step)."""
        self.confusion_matrix += np.asarray(torch.as_tensor(cm).cpu(), dtype=np.float64)

    def synchronize_between_processes(self) -> None:
        """No-op: one device (data-parallel training is ROADMAP queue 1 item 4)."""
        return

    @property
    def global_avg(self) -> float:
        return miou_from_confusion(self.confusion_matrix)
