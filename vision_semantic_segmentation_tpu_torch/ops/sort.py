"""LSD radix sort for bounded non-negative int32 keys, plain PyTorch.

Port of ``vision_semantic_segmentation_tpu/ops/sort.py``; no kernel of
its own.  ``MAPPING.SORT_METHOD = 'radix'`` sorts the keys of the engine's
``'scatter'`` fold with it (``'bitonic'`` is ``torch.sort``).  Each pass
ranks the keys stably within their digit and scatters them to a
permutation of [0, n):

    digit  = (k >> shift) & (radix - 1)
    onehot = one_hot(digit, radix).T         # (radix, N) f32
    run    = cumsum(onehot, dim=1)           # stable rank within the digit
    dst    = offsets[digit] + rank           # a permutation of [0, n)
    out[dst] = k

Ranks and offsets are f32, exact for n < 2^24, as in the JAX module;
``ceil(key_bits / digit_bits)`` passes run.  The one-hot is held digit-major,
so the running count is a scan along the inner dimension: on the card a
scan along the outer dimension of an (N, 16) tensor walks each column in
sequence.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["radix_sort", "radix_sort_with_perm"]


def _check_args(keys: torch.Tensor, digit_bits: int) -> None:
    if keys.ndim != 1:
        raise ValueError(f"radix sort expects a 1-D array, got {tuple(keys.shape)}")
    if keys.shape[0] >= 1 << 24:
        raise ValueError(f"n={keys.shape[0]} overflows exact f32 rank arithmetic (2^24)")
    if not 1 <= digit_bits <= 8:
        raise ValueError(f"digit_bits must be in [1, 8], got {digit_bits}")


def _pass_dst(keys: torch.Tensor, shift: int, radix: int) -> torch.Tensor:
    """Stable per-pass scatter destinations (a permutation of [0, n))."""
    digit = ((keys >> shift) & (radix - 1)).long()
    # a comparison, not F.one_hot, which checks its input on the host
    oh = (torch.arange(radix, device=keys.device)[:, None] == digit).to(torch.float32)
    run = torch.cumsum(oh, dim=1)
    counts = run[:, -1]
    offsets = torch.cumsum(counts, dim=0) - counts
    rank = (run * oh).sum(dim=0) - 1.0
    return (offsets[digit] + rank).long()


def _scatter(values: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(values).index_put_((dst,), values)


def radix_sort(keys: torch.Tensor, key_bits: int, digit_bits: int = 4) -> torch.Tensor:
    """Sort 1-D non-negative int32 ``keys`` < ``2**key_bits`` ascending."""
    _check_args(keys, digit_bits)
    radix = 1 << digit_bits
    for shift in range(0, key_bits, digit_bits):
        keys = _scatter(keys, _pass_dst(keys, shift, radix))
    return keys


def radix_sort_with_perm(keys: torch.Tensor, key_bits: int,
                         digit_bits: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ``(sorted_keys, argsort_permutation)``: LSD radix is stable,
    so the permutation is ``torch.sort(keys, stable=True)``'s, duplicates
    included."""
    _check_args(keys, digit_bits)
    radix = 1 << digit_bits
    perm = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    for shift in range(0, key_bits, digit_bits):
        dst = _pass_dst(keys, shift, radix)
        keys, perm = _scatter(keys, dst), _scatter(perm, dst)
    return keys, perm
