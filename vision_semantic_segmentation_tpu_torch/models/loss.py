"""Segmentation loss.

Port of ``vision_semantic_segmentation_tpu/models/loss.py`` (the
reference's ``nn.CrossEntropyLoss(ignore_index=255)`` wrapper, ref
models/loss.py:4-18): softmax cross entropy, ignored labels left out of the
mean, which divides by the summed weights of the counted pixels.

Logits are NCHW, as the port's models give them; the class axis is 1.  A
batch whose every label is ``ignore_index`` has loss 0, as in the JAX
package (``0 / max(sum w, 1e-12)``), where ``F.cross_entropy`` with
``reduction="mean"`` gives NaN.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean softmax cross entropy over non-ignored pixels, in f32.

    Args:
        logits: (N, C, ...) unnormalized scores.
        labels: (N, ...) integer labels; ``ignore_index`` entries are skipped.
        weight: optional (C,) per-class weights (torch semantics: the mean
            is divided by the summed weights of counted elements).
    """
    total, count = cross_entropy_sum_count(logits, labels, ignore_index, weight)
    return total / count.clamp_min(1e-12)


def cross_entropy_sum_count(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's two halves: the weighted sum of the counted pixels' cross
    entropy and the sum of their weights.  A data-parallel step divides the
    local sum by the count summed over ranks: the mean over the global
    batch's counted pixels, which the mean of per-rank means is not once
    ranks hold different numbers of ignored pixels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    log_probs = F.log_softmax(logits.float(), dim=1)
    nll = -log_probs.gather(1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)[safe]
    else:
        w = torch.ones_like(nll)
    w = torch.where(valid, w, torch.zeros_like(w))
    return (nll * w).sum(), w.sum()


class CrossEntropyLoss:
    """Callable matching the reference loss object's signature."""

    def __init__(self, weight=None, ignore_index: int = -100):
        self.weight = weight
        self.ignore_index = ignore_index

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return cross_entropy_loss(logits, labels, ignore_index=self.ignore_index,
                                  weight=self.weight)
