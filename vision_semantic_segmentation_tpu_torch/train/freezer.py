"""Parameter freezing.

Port of ``vision_semantic_segmentation_tpu/train/freezer.py`` (ref
core/nn/freezer.py:95-118 ``freeze_bn`` and the TRAIN.FROZEN_PATTERNS
hook, ref config/base.py:133).  The JAX package masks the optimizer update
of matching parameters; here they are left out of the optimizer, which
updates nothing else of them (no step, no weight decay, no momentum).  Their
gradients are still computed, as JAX computes them before the mask, so a
global-norm clip sees the same gradient norm.  Patterns are regular
expressions searched in the parameter's PyTorch name
(``backbone.layer1.0.conv1.weight``), the reference's names.
``TRAIN.FREEZE_BATCHNORM`` freezes every BatchNorm's weight and bias; the
train step keeps their running statistics fixed (``freeze_bn_stats``).
"""
from __future__ import annotations

import re
from typing import List, Sequence, Set

import torch.nn as nn


def bn_parameter_names(model: nn.Module) -> Set[str]:
    """Names of the BatchNorm weights and biases (the JAX package's ``bn_mask``)."""
    return {
        f"{mod_name}.{p_name}" if mod_name else p_name
        for mod_name, mod in model.named_modules()
        if isinstance(mod, nn.modules.batchnorm._BatchNorm)
        for p_name, _ in mod.named_parameters(recurse=False)
    }


def frozen_parameter_names(model: nn.Module, patterns: Sequence[str] = (),
                           freeze_batchnorm: bool = False) -> Set[str]:
    """Names matching any pattern, plus the BatchNorm parameters if asked."""
    compiled = [re.compile(p) for p in patterns]
    frozen = {name for name, _ in model.named_parameters()
              if any(c.search(name) for c in compiled)}
    if freeze_batchnorm:
        frozen |= bn_parameter_names(model)
    return frozen


def trainable_parameters(model: nn.Module, patterns: Sequence[str] = (),
                         freeze_batchnorm: bool = False) -> List[nn.Parameter]:
    """The parameters the optimizer updates."""
    frozen = frozen_parameter_names(model, patterns, freeze_batchnorm)
    return [p for name, p in model.named_parameters() if name not in frozen]
