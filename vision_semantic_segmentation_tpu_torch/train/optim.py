"""Optimizer + LR schedule builders on ``torch.optim``.

Port of ``vision_semantic_segmentation_tpu/train/optim.py`` (ref
core/optim/build.py:15-66, lr_scheduler.py:7-33): SGD (momentum, nesterov)
and Adam from the config tree, with StepLR / MultiStepLR / PolyLRDecay
schedules.  The semantics are the JAX package's optax chains:

  * weight decay is L2 added to the gradient before momentum or Adam's
    moments (``optax.add_decayed_weights`` first in the chain), which is
    ``torch.optim.SGD``/``Adam``'s ``weight_decay``;
  * SGD momentum is optax's ``trace`` (``b = momentum * b + g``, the first
    step ``b = g``; nesterov ``g + momentum * b``), which is torch's SGD
    with dampening 0; dampening > 0 is refused, as the JAX package does;
  * a schedule is a function ``step -> lr`` of the number of updates
    already applied (optax's ``count``), so step 0 gets ``BASE_LR``; it runs
    through ``LambdaLR``, stepped once after every optimizer step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

Schedule = Callable[[int], float]

_OPTIMIZER_BUILDERS: Dict[str, Callable] = {}
_SCHEDULER_BUILDERS: Dict[str, Callable] = {}


def register_optimizer_builder(name: str, builder: Callable) -> None:
    """``builder(cfg, params) -> torch.optim.Optimizer``."""
    if name in _OPTIMIZER_BUILDERS:
        raise KeyError(f"Duplicate optimizer builder {name}")
    _OPTIMIZER_BUILDERS[name] = builder


def register_scheduler_builder(name: str, builder: Callable) -> None:
    """``builder(cfg) -> (step -> lr)``."""
    if name in _SCHEDULER_BUILDERS:
        raise KeyError(f"Duplicate scheduler builder {name}")
    _SCHEDULER_BUILDERS[name] = builder


def polynomial_lr_decay(base_lr: float, max_iter: int, power: float = 0.9) -> Schedule:
    """lr = base * (1 - step/max_iter)^power, frozen past max_iter.

    (ref lr_scheduler.py:27-33; the reference keeps returning the last lr
    once ``step >= max_iter``.)
    """
    if max_iter <= 1:
        raise ValueError("max_iter should be greater than 1")

    def schedule(step: int) -> float:
        frac = min(max(step / max_iter, 0.0), (max_iter - 1) / max_iter)
        return base_lr * (1.0 - frac) ** power

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch StepLR equivalent."""
    return lambda step: base_lr * gamma ** (step // step_size)


def multi_step_lr(base_lr: float, milestones: Iterable[int], gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR equivalent."""
    milestones = sorted(milestones)
    return lambda step: base_lr * gamma ** sum(step >= m for m in milestones)


def build_schedule(cfg) -> Optional[Schedule]:
    """Config -> ``step -> lr`` (ref build.py:48-66); None for a constant lr."""
    name = cfg.SCHEDULER.TYPE
    base_lr = cfg.OPTIMIZER.BASE_LR
    if name == "":
        return None
    if name == "PolyLRDecay":
        node = cfg.SCHEDULER.PolyLRDecay
        return polynomial_lr_decay(base_lr, node.max_iter, node.power)
    if name == "StepLR":
        node = cfg.SCHEDULER.StepLR
        return step_lr(base_lr, node.step_size, node.gamma)
    if name == "MultiStepLR":
        node = cfg.SCHEDULER.MultiStepLR
        return multi_step_lr(base_lr, list(node.milestones), node.gamma)
    if name in _SCHEDULER_BUILDERS:
        return _SCHEDULER_BUILDERS[name](cfg)
    raise ValueError(f"Unsupported scheduler {name!r}")


def build_optimizer(cfg, params) -> torch.optim.Optimizer:
    """Config -> optimizer over ``params`` at ``OPTIMIZER.BASE_LR`` (ref build.py:15-32)."""
    name = cfg.OPTIMIZER.TYPE
    lr = cfg.OPTIMIZER.BASE_LR
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    if name == "SGD":
        node = cfg.OPTIMIZER.SGD
        if node.momentum > 0 and node.dampening > 0:
            raise NotImplementedError("SGD dampening > 0 is not supported")
        return torch.optim.SGD(params, lr=lr, momentum=node.momentum,
                               nesterov=bool(node.nesterov), weight_decay=wd)
    if name == "Adam":
        b1, b2 = cfg.OPTIMIZER.Adam.betas
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=wd)
    if name in _OPTIMIZER_BUILDERS:
        return _OPTIMIZER_BUILDERS[name](cfg, params)
    raise ValueError(f"Unsupported optimizer {name!r}")


def build_scheduler(optimizer: torch.optim.Optimizer,
                    schedule: Optional[Schedule]) -> torch.optim.lr_scheduler.LambdaLR:
    """``LambdaLR`` whose lr after k ``step()`` calls is ``schedule(k)`` (the
    optimizer's own lr throughout when ``schedule`` is None)."""
    base = [group["lr"] for group in optimizer.param_groups]
    if schedule is None:
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, [lambda step, b=b: schedule(step) / b for b in base])
