"""The single-device training step.

Port of the single-device part of
``vision_semantic_segmentation_tpu/parallel/train_step.py``: one fused step
of forward, loss, backward, update and metrics (``make_train_step``) and
the evaluation step (``make_eval_step``).  The data-parallel, per-device
BatchNorm and spatial steps are not ported (ROADMAP queue 1 items 4 and
5); on one card the per-device BatchNorm step equals this one.

The state is mutable here: :class:`TrainState` holds the module (f32
parameters, BatchNorm buffers), the optimizer and its ``LambdaLR`` schedule,
the step count and the generator the augmentation draws from; a step
updates it in place.  Dropout draws from the device's default generator,
which ``utils.set_random_seed`` seeds and the checkpoint saves (the golden
trainer, ``evaluation/synthetic_scene.py::train_segmenter``, forks it and
seeds its own copy).

``compute_dtype`` bfloat16 runs the forward under ``torch.autocast`` with
f32 parameters, loss and gradients (the JAX package's flax dtype
semantics).  The depthwise convs of ASPP go through K4 forward and K3 dgrad
on the card (``ops/kernels/depthwise.py::DepthwiseBranches``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from ..models.layers import checkpointed
from ..models.loss import cross_entropy_loss
from ..models.metrics import confusion_matrix_update

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Training state: model, optimizer, LR schedule, step, augment generator."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0


def _bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]


def _forward(model: nn.Module, image: torch.Tensor, remat: bool, dtype: torch.dtype):
    with torch.autocast(image.device.type, dtype=dtype, enabled=dtype != torch.float32):
        if remat:
            return checkpointed(model, lambda x: model(x, upsample_pred=True), image)
        return model(image, upsample_pred=True)


def _nchw(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> an NCHW view in channels-last memory; an
    integer image as f32, a float one in its own type (as the JAX step
    passes it on)."""
    return (image if image.is_floating_point() else image.float()).permute(0, 3, 1, 2)


def make_train_step(
    num_classes: int,
    ignore_index: int = 255,
    max_grad_norm: float = 0.0,
    freeze_bn_stats: bool = False,
    remat: bool = False,
    accum_steps: int = 1,
    augment: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """Build the train step ``step(state, batch) -> {"loss", "confusion"}``.

    ``batch``: ``image`` (B, H, W, 3) float32 NHWC (raw uint8 with
    ``augment``), ``label`` (B, H, W) integer, on the model's device.  The
    returned loss and (C, C) confusion stay on the device (no host sync);
    the confusion is taken from the pre-update logits.

    ``freeze_bn_stats`` keeps the BatchNorm running statistics fixed (the
    eval-mode half of the reference's freeze_bn); normalisation still uses
    the batch statistics.  ``remat`` recomputes the forward in the backward
    pass (``torch.utils.checkpoint``).  ``accum_steps`` > 1 splits the batch
    into micro-batches in sequence (BatchNorm statistics are
    micro-batch-local and the running statistics thread through them),
    sums their gradients, divides by ``accum_steps`` and applies one update;
    the loss is the micro-batches' mean.  ``max_grad_norm`` > 0 scales the
    gradients by ``min(1, max / max(global_norm, 1e-12))`` (optax's
    global norm over every parameter with a gradient).  ``augment`` maps
    ``(generator, batch) -> batch`` before the step
    (``train/augment.py``).
    """

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        if augment is not None:
            batch = augment(state.generator, batch)
        model.train()
        saved = [b.clone() for b in _bn_buffers(model)] if freeze_bn_stats else None
        model.zero_grad(set_to_none=True)
        image, label = batch["image"], batch["label"]
        b = image.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch of {b} does not split into {accum_steps} micro-batches")
        micro = b // accum_steps
        loss_sum = confusion = None
        for i in range(accum_steps):
            img = _nchw(image[i * micro : (i + 1) * micro])
            lab = label[i * micro : (i + 1) * micro]
            logits = _forward(model, img, remat, compute_dtype)
            loss = cross_entropy_loss(logits, lab, ignore_index=ignore_index)
            loss.backward()
            cm = confusion_matrix_update(logits.detach(), lab, num_classes)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            confusion = cm if confusion is None else confusion + cm
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        if max_grad_norm > 0 and grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.clamp(max_grad_norm / torch.clamp(norm, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, scale)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if saved is not None:
            with torch.no_grad():
                for buf, old in zip(_bn_buffers(model), saved):
                    buf.copy_(old)
        return {"loss": loss_sum / accum_steps, "confusion": confusion}

    return train_step


def make_eval_step(num_classes: int, ignore_index: int = 255,
                   compute_dtype: torch.dtype = torch.float32):
    """Validation step: forward (running statistics) + loss + confusion, no updates."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            logits = _forward(model, _nchw(batch["image"]), False, compute_dtype)
        finally:
            model.train(was_training)
        label = batch["label"]
        return {
            "loss": cross_entropy_loss(logits, label, ignore_index=ignore_index),
            "confusion": confusion_matrix_update(logits, label, num_classes),
        }

    return eval_step
