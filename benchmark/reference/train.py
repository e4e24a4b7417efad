"""Plain PyTorch training steps of DeepLabV3+: forward in training mode
(BatchNorm on the batch's statistics), softmax cross entropy over the
logits resized to the input (bilinear, corners aligned) with the ignored
label left out of the mean, autograd's backward, and SGD with momentum and
L2 weight decay added to the gradient (``d = g + wd p``; ``b = d`` on the
optimizer's first step, ``b = m b + d`` after; ``p -= lr b``) under the polynomial
learning-rate decay ``lr = base (1 - min(k / max_iter, (max_iter - 1) /
max_iter)) ** power`` at step k from 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, label: torch.Tensor, ignore: int = 255) -> torch.Tensor:
    valid = label != ignore
    logp = F.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, torch.where(valid, label, 0).long()[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def poly_lr(train: dict, k: int) -> float:
    frac = min(max(k / train["poly_max_iter"], 0.0),
               (train["poly_max_iter"] - 1) / train["poly_max_iter"])
    return train["base_lr"] * (1.0 - frac) ** train["poly_power"]


def sgd_steps(model: nn.Module, train: dict,
              batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], start: int = 0,
              bufs: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                         torch.Tensor]:
    """Steps ``start``, ``start + 1``, ... over ``batches`` of (image (B, 3,
    H, W) f32, label (B, H, W)), from the momentum buffers ``bufs`` (None:
    the optimizer's first step).  Returns each step's loss, the first
    step's gradient as the optimizer takes it (with weight decay), its raw
    gradients and its predictions (the argmax of its logits before the
    update)."""
    params = dict(model.named_parameters())
    bufs = {n: b.clone() for n, b in bufs.items()} if bufs is not None else {}
    losses, taken, raw, preds = [], {}, {}, None
    for k, (image, label) in enumerate(batches):
        model.zero_grad(set_to_none=True)
        logits = model(image, upsample=True)
        loss = cross_entropy(logits, label)
        if k == 0:
            preds = logits.detach().argmax(1)
        loss.backward()
        losses.append(float(loss.detach()))
        lr = poly_lr(train, start + k)
        with torch.no_grad():
            for name, p in params.items():
                d = p.grad + train["weight_decay"] * p
                if k == 0:
                    taken[name] = d.clone()
                    raw[name] = p.grad.clone()
                bufs[name] = train["momentum"] * bufs[name] + d if name in bufs else d.clone()
                p -= lr * bufs[name]
        del logits, loss
    return losses, taken, raw, preds


def confusion(preds: torch.Tensor, label: torch.Tensor, classes: int) -> torch.Tensor:
    """(C, C) counts of (truth, prediction) over the pixels whose label is a class."""
    valid = (label >= 0) & (label < classes)
    return torch.bincount((label[valid] * classes + preds[valid]).long(),
                          minlength=classes * classes).reshape(classes, classes)
