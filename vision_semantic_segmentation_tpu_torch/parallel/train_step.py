"""The training steps: one device, and data-parallel over a process group.

Port of ``vision_semantic_segmentation_tpu/parallel/train_step.py``: one
fused step of forward, loss, backward, update and metrics
(``make_train_step``), the evaluation step (``make_eval_step``), K steps
over a stacked batch (``make_multi_train_step``) and the data-parallel
step with per-device BatchNorm statistics
(``make_per_device_bn_train_step``), and the spatially sharded steps
(``make_spatial_train_step``, ``make_spatial_eval_step``: image rows banded
over a mesh axis, ``parallel/spatial_infer.py``).

Data parallelism is one rank per card over ``torch.distributed``
(``parallel/distributed.py``), each rank stepping on its slice of the global
batch.  The JAX package's ``jit_*`` wrappers have no counterpart, as there
is nothing to jit; each maps to a ``group=`` form here:

  * ``jit_train_step(make_train_step(...), mesh)`` ->
    ``make_train_step(..., group=g)``: BatchNorm over the global batch, the
    loss the global batch's mean over counted pixels, the gradients and
    confusion summed over ranks;
  * ``jit_multi_train_step(make_multi_train_step(...), mesh)`` ->
    ``make_multi_train_step(..., group=g)``;
  * ``jit_eval_step(make_eval_step(...), mesh)`` -> ``make_eval_step(...,
    group=g)``;
  * ``make_per_device_bn_train_step(num_classes, mesh)`` ->
    ``make_per_device_bn_train_step(num_classes, g)``;
  * ``jit_spatial_train_step(make_train_step(...), mesh, data_axis,
    spatial_axis, steps_axis)`` -> ``make_spatial_train_step(num_classes,
    mesh, data_axis, spatial_axis, steps=K, ...)``, and
    ``jit_spatial_eval_step`` -> ``make_spatial_eval_step``: one process
    over the mesh's devices, or, with ``group=world.spatial_groups(S)``,
    bands across the ranks of a process group (rank r holds band ``r % S``
    of data group ``r // S``).

After a local backward, one all-reduce sums the gradients with the loss
and the confusion (per-device steps: the running statistics too), and every
rank applies the same update: no DDP wrapper (it would broadcast rank 0's
buffers at every forward, rename the state dict's keys and need
``no_sync`` for accumulation).  Each rank's dropout and augmentation draw
from its own generators, which the trainer seeds from the run's seed and
the rank (``distributed.rank_seed``).

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

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.layers import checkpointed, global_batch_statistics
from ..models.loss import cross_entropy_loss, cross_entropy_sum_count
from ..models.metrics import confusion_matrix_update
from ..utils.benchmark import span
from .distributed import SpatialGroups, all_reduce_
from .mesh import Mesh
from .spatial_infer import Bands, SpatialModel

Batch = Dict[str, torch.Tensor]
Step = Callable[["TrainState", Batch], Dict[str, torch.Tensor]]

_PER_DEVICE_REMAT = (
    "remat requires the SyncBN train step (MODEL.SYNC_BN=True, a single device, or "
    "TRAIN.FREEZE_BATCHNORM=True); the per-device-BN path does not support it")
_PER_DEVICE_ACCUM = (
    "TRAIN.GRAD_ACCUM_STEPS > 1 requires the SyncBN train step (MODEL.SYNC_BN=True or a "
    "single device); the per-device-BN path does not support it")


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


def _running_stats(model: nn.Module) -> List[torch.Tensor]:
    """The BatchNorms' running means and variances (not their batch counts)."""
    return [t for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var) if t is not None]


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


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _global_mean_loss(logits, label, ignore_index: int, group) -> torch.Tensor:
    """The local sum over the count summed over ``group``'s ranks."""
    total, count = cross_entropy_sum_count(logits, label, ignore_index=ignore_index)
    dist.all_reduce(count, group=group)
    return total / count.clamp_min(1e-12)


def _clip_(grads: List[torch.Tensor], max_grad_norm: float) -> None:
    """Scale by ``min(1, max / max(global_norm, 1e-12))`` (optax's global norm
    over every parameter with a gradient)."""
    if max_grad_norm > 0 and grads:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.clamp(max_grad_norm / torch.clamp(norm, min=1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)


def _update(state: TrainState) -> None:
    with span("train.update"):
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1


def make_train_step(
    num_classes: int,
    ignore_index: int = 255,
    max_grad_norm: float = 0.0,
    freeze_bn_stats: bool = False,
    remat: bool = False,
    accum_steps: int = 1,
    augment: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.float32,
    group=None,
) -> Step:
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

    ``group`` (a ``torch.distributed`` group; ``batch`` is this rank's slice
    of the global batch): the data-parallel step of the JAX package's
    ``jit_train_step``.  BatchNorm takes the global batch's statistics (on
    more than one rank), each micro-batch's loss is its global mean over
    counted pixels, and after the micro-batches one all-reduce sums the
    gradients, the loss and the confusion; clipping sees the summed
    gradient.
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
        sync = _world(group) > 1
        loss_sum = confusion = None
        for i in range(accum_steps):
            img = _nchw(image[i * micro : (i + 1) * micro])
            lab = label[i * micro : (i + 1) * micro]
            with (global_batch_statistics(model, group) if sync else contextlib.nullcontext()):
                with span("train.forward"):
                    logits = _forward(model, img, remat, compute_dtype)
                    loss = (cross_entropy_loss(logits, lab, ignore_index=ignore_index)
                            if group is None
                            else _global_mean_loss(logits, lab, ignore_index, group))
                with span("train.backward"):
                    loss.backward()
            cm = confusion_matrix_update(logits.detach(), lab, num_classes)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            confusion = cm if confusion is None else confusion + cm
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if group is not None:
            all_reduce_(grads + [loss_sum, confusion], group)
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        _clip_(grads, max_grad_norm)
        _update(state)
        if saved is not None:
            with torch.no_grad():
                for buf, old in zip(_bn_buffers(model), saved):
                    buf.copy_(old)
        return {"loss": loss_sum / accum_steps, "confusion": confusion}

    return train_step


def make_per_device_bn_train_step(
    num_classes: int,
    group,
    ignore_index: int = 255,
    max_grad_norm: float = 0.0,
    steps: int = 1,
    augment: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    accum_steps: int = 1,
) -> Step:
    """Data-parallel train step with per-device BatchNorm statistics (the
    reference's DDP default, ``MODEL.SYNC_BN`` False).

    Each rank normalises with its own slice's statistics and takes its
    local mean loss; one all-reduce then sums the gradients, the loss, the
    running statistics and the confusion, and the first three are divided
    by the number of ranks: the gradient of the mean over ranks of the
    local losses (JAX's ``pmean`` inside the differentiated loss), the
    reported loss that mean, the stored running statistics the mean over
    ranks (the JAX package's deterministic rule, not DDP's rank 0), the
    confusion the sum.  ``max_grad_norm`` clips the mean gradient.

    ``steps`` > 1 returns :func:`make_multi_train_step`'s form over a
    stacked ``(steps, B, ...)`` batch.  ``remat`` and ``accum_steps`` > 1
    raise, as the JAX trainer refuses them on this path.
    """
    if remat:
        raise NotImplementedError(_PER_DEVICE_REMAT)
    if accum_steps > 1:
        raise NotImplementedError(_PER_DEVICE_ACCUM)
    ranks = float(_world(group))

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        if augment is not None:
            batch = augment(state.generator, batch)
        model.train()
        model.zero_grad(set_to_none=True)
        label = batch["label"]
        with span("train.forward"):
            logits = _forward(model, _nchw(batch["image"]), False, compute_dtype)
            loss = cross_entropy_loss(logits, label, ignore_index=ignore_index)
        with span("train.backward"):
            loss.backward()
        confusion = confusion_matrix_update(logits.detach(), label, num_classes)
        loss = loss.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        means = grads + [loss] + _running_stats(model)
        with torch.no_grad():
            all_reduce_(means + [confusion], group)
            torch._foreach_div_(means, ranks)
        _clip_(grads, max_grad_norm)
        _update(state)
        return {"loss": loss, "confusion": confusion}

    return _stacked(train_step, steps) if steps > 1 else train_step


def _stacked(step: Step, steps: int) -> Step:
    """``steps`` calls of ``step``, one a slice of a ``(steps, B, ...)`` batch."""

    def multi_step(state: TrainState, batches: Batch) -> Dict[str, torch.Tensor]:
        k = batches["image"].shape[0]
        if k != steps:
            raise ValueError(f"a stacked batch of {k} steps for a {steps}-step dispatch")
        ms = [step(state, {key: v[i] for key, v in batches.items()}) for i in range(k)]
        return {"loss": torch.stack([m["loss"] for m in ms]),
                "confusion": torch.stack([m["confusion"] for m in ms])}

    return multi_step


def make_multi_train_step(num_classes: int, steps: int, **kwargs) -> Step:
    """``steps`` train steps over a batch stacked ``(steps, B, ...)``, each
    :func:`make_train_step`'s (``kwargs`` are its own, ``group`` among
    them).  Returns the loss ``(steps,)`` and the per-step confusion
    ``(steps, C, C)``, which the host sums in float64 (each step's counts
    are exact in f32, a sum of K steps need not be)."""
    return _stacked(make_train_step(num_classes, **kwargs), steps)


def make_eval_step(num_classes: int, ignore_index: int = 255,
                   compute_dtype: torch.dtype = torch.float32, group=None):
    """Validation step: forward (running statistics) + loss + confusion, no
    updates.  With ``group``, one all-reduce makes the loss the global
    batch's mean over counted pixels and sums the confusion."""

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
        confusion = confusion_matrix_update(logits, label, num_classes)
        if group is None:
            return {"loss": cross_entropy_loss(logits, label, ignore_index=ignore_index),
                    "confusion": confusion}
        total, count = cross_entropy_sum_count(logits, label, ignore_index=ignore_index)
        all_reduce_([total, count, confusion], group)
        return {"loss": total / count.clamp_min(1e-12), "confusion": confusion}

    return eval_step


def _spatial_engine(cache: dict, model: nn.Module, mesh: Optional[Mesh],
                    data_axis: Optional[str], spatial_axis: str,
                    group: Optional[SpatialGroups]) -> SpatialModel:
    """The banded forward of ``model`` over ``mesh`` (or ``group``'s ranks),
    built once a model."""
    key = id(model)
    if key not in cache:
        cache.clear()
        cache[key] = SpatialModel(model, mesh, spatial_axis=spatial_axis, data_axis=data_axis,
                                  ranks=group)
    return cache[key]


def _spatial_logits(engine: SpatialModel, image: torch.Tensor, remat: bool,
                    dtype: torch.dtype) -> Bands:
    """The upsampled logits of an NHWC batch as bands; ``remat`` recomputes
    the whole banded forward, halo fetches included, in the backward."""
    x = engine.split(_nchw(image))
    model = engine.model
    with torch.autocast(image.device.type, dtype=dtype, enabled=dtype != torch.float32):
        return engine._block(model, model, lambda b: engine(b, upsample_pred=True), x, remat)


def spatial_loss(logits: Bands, labels: Bands, num_classes: int, ignore_index: int,
                  home: torch.device, group: Optional[SpatialGroups] = None):
    """The mean cross entropy over the counted pixels of every band and the
    confusion: per-band sums added in mesh order on ``home``.  With
    ``group`` (bands across ranks) the count is summed over the world: the
    loss is this band's share of the global batch's mean, and the
    confusion this band's counts; summed over ranks, they are the whole."""
    total = count = confusion = None
    for lg, lb in zip(logits.shards, labels.shards):
        t, c = cross_entropy_sum_count(lg, lb, ignore_index=ignore_index)
        cm = confusion_matrix_update(lg.detach(), lb, num_classes).to(home)
        t, c = t.to(home), c.to(home)
        total = t if total is None else total + t
        count = c if count is None else count + c
        confusion = cm if confusion is None else confusion + cm
    if group is not None:
        with group.traffic.record("all_reduce", home):
            dist.all_reduce(count, group=group.world.group)
    return total / count.clamp_min(1e-12), confusion


def _check_micro(micro: int, engine: SpatialModel) -> None:
    if micro % len(engine.groups):
        raise ValueError(f"a (micro-)batch of {micro} does not split over the data axis of "
                         f"{len(engine.groups)} shards")


def make_spatial_train_step(
    num_classes: int,
    mesh: Optional[Mesh],
    data_axis: Optional[str] = "data",
    spatial_axis: str = "spatial",
    steps: int = 1,
    ignore_index: int = 255,
    max_grad_norm: float = 0.0,
    freeze_bn_stats: bool = False,
    remat: bool = False,
    accum_steps: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    group: Optional[SpatialGroups] = None,
) -> Step:
    """The train step with image rows banded over ``mesh[spatial_axis]``
    and the batch over ``mesh[data_axis]`` (None: a pure-spatial mesh), the
    JAX package's ``jit_spatial_train_step(make_train_step(...), mesh)``.

    ``batch`` is the whole global batch (``image`` (B, H, W, 3) float NHWC,
    ``label`` (B, H, W)) on any device; the step splits each micro-batch
    over the mesh (``spatial_infer.Bands``).  The forward is banded
    (explicit halos; autograd carries them back), BatchNorm takes its
    statistics over every band and data shard in a fixed order, the loss is
    the mean over the counted pixels of every band (per-band sums added in
    mesh order), and the confusion the bands' counts added.  Parameters and
    optimizer state stay on the model's device; copies on the mesh's other
    devices are refreshed before the forward, and their gradients added
    onto the model's in mesh order.  The other arguments are
    :func:`make_train_step`'s; ``steps`` > 1 takes a ``(steps, B, ...)``
    stacked batch (JAX's ``steps_axis=True``).

    ``group`` (``World.spatial_groups(S)``; ``mesh`` None): bands across
    the ranks of a process group.  ``batch`` is this rank's data group's
    slice of the global batch, every row; the step keeps its band's rows.
    Halos move between the image's ranks, BatchNorm's sums and the loss's
    count are all-reduced over the world, and after the micro-batches one
    flat all-reduce sums the gradients (each band's a partial sum), the
    loss and the confusion, so every rank applies the same update from the
    parameters broadcast at the start.  At the end of the step the ranks
    check that they made the same number of collective calls.
    """
    engines: dict = {}

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        engine = _spatial_engine(engines, model, mesh, data_axis, spatial_axis, group)
        model.train()
        engine.sync()
        saved = [b.clone() for b in _bn_buffers(model)] if freeze_bn_stats else None
        engine.zero_grad()
        image, label = batch["image"], batch["label"]
        b = image.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch of {b} does not split into {accum_steps} micro-batches")
        micro = b // accum_steps
        _check_micro(micro, engine)
        loss_sum = confusion = None
        for i in range(accum_steps):
            logits = _spatial_logits(engine, image[i * micro : (i + 1) * micro], remat,
                                     compute_dtype)
            labels = engine.split(label[i * micro : (i + 1) * micro], 1)
            loss, cm = spatial_loss(logits, labels, num_classes, ignore_index, engine.home, group)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            confusion = cm if confusion is None else confusion + cm
        engine.reduce_grads()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if group is not None:
            all_reduce_(grads + [loss_sum, confusion], group.world.group)
            group.check_calls()
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        _clip_(grads, max_grad_norm)
        _update(state)
        if saved is not None:
            with torch.no_grad():
                for buf, old in zip(_bn_buffers(model), saved):
                    buf.copy_(old)
        return {"loss": loss_sum / accum_steps, "confusion": confusion}

    return _stacked(train_step, steps) if steps > 1 else train_step


def make_spatial_eval_step(num_classes: int, mesh: Optional[Mesh],
                           data_axis: Optional[str] = "data", spatial_axis: str = "spatial",
                           ignore_index: int = 255,
                           compute_dtype: torch.dtype = torch.float32,
                           group: Optional[SpatialGroups] = None):
    """Validation step with image rows banded over ``mesh[spatial_axis]``
    (JAX ``jit_spatial_eval_step``): the banded forward with the running
    statistics, the loss and the confusion as in
    :func:`make_spatial_train_step`, no updates.  A batch that does not
    split over the data axis is padded with copies of its first image
    labelled ``ignore_index`` (the JAX trainer's padding), which change
    neither the loss nor the confusion.

    ``group``: bands across ranks, ``batch`` this rank's data group's slice
    (the distributed loader pads a remainder batch to the data groups with
    ignored copies); one all-reduce sums the loss shares and the confusion.
    """
    engines: dict = {}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        engine = _spatial_engine(engines, model, mesh, data_axis, spatial_axis, group)
        pad = -batch["image"].shape[0] % len(engine.groups)
        if pad:
            label = batch["label"]
            batch = {"image": torch.cat([batch["image"], batch["image"][:1].expand(
                         pad, *batch["image"].shape[1:])]),
                     "label": torch.cat([label, label.new_full((pad, *label.shape[1:]),
                                                               ignore_index)])}
        was_training = model.training
        model.eval()
        try:
            engine.sync()
            logits = _spatial_logits(engine, batch["image"], False, compute_dtype)
        finally:
            model.train(was_training)
        labels = engine.split(batch["label"], 1)
        loss, confusion = spatial_loss(logits, labels, num_classes, ignore_index, engine.home,
                                       group)
        if group is not None:
            all_reduce_([loss, confusion], group.world.group)
            group.check_calls()
        return {"loss": loss, "confusion": confusion}

    return eval_step
