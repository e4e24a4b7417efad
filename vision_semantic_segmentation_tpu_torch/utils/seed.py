"""Reproducibility helpers (ref core/utils/torch_util.py:7-16).

Port of ``vision_semantic_segmentation_tpu/utils/seed.py``: seed Python's
``random`` (the host transforms draw from it), numpy and PyTorch (every
device's default generator; dropout draws from it).  The JAX package
returns a root PRNG key; the port returns the seed, from which callers
make their explicit ``torch.Generator``s.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def set_random_seed(seed: Optional[int]) -> Optional[int]:
    """Seed python/numpy/torch; a negative seed is a no-op and returns None."""
    if seed is None or seed < 0:
        return None
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)
