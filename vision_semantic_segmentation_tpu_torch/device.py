"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA.  A
missing card raises: nothing drops silently to the CPU.  Callers that want
the CPU (the parity tests) pass ``device="cpu"``, and on the CPU every
kernel wrapper runs its plain PyTorch version.

Precision: the JAX package runs geometry and evidence-fold matmuls at
``Precision.HIGHEST`` (full f32).  On the card a float32 matmul is full
f32 unless TF32 is allowed, and cuDNN's float32 convolutions default to
TF32, so both switches are turned off here.  The geometry, the fold
reference (``torch.addmm`` is only a yardstick) and the f32 model path
rely on them; the bf16 model path relies on neither, because bf16
convolutions and matmuls use the bf16 tensor-core path either way.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
