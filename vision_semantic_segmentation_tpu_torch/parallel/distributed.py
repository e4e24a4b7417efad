"""The process group of data-parallel training: one rank per card.

Counterpart of the JAX Trainer's ``_ensure_distributed``
(``vision_semantic_segmentation_tpu/train/trainer.py:59-69``) and of
``jax.distributed``.  JAX runs data-parallel training as one SPMD program
over a mesh; PyTorch's form is one process per card under ``torchrun``,
joined by ``torch.distributed``: NCCL between cards, gloo on the CPU.

:func:`ensure_distributed` joins the group from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
unless the process already opened one, and refuses to run without it: a
run asked to be distributed never falls back to one process.  The
collectives are ``all_reduce`` and ``broadcast`` alone, which gloo carries
for CPU and CUDA tensors alike (two ranks on one card, where NCCL refuses
to run, go over gloo).  Host-side agreement (the preemption flag, the
barrier after a checkpoint) goes over a gloo group on CPU tensors, so it
never waits for the card.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..device import DeviceLike, resolve_device

TIMEOUT = datetime.timedelta(minutes=30)
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# the gloo group for host tensors of each NCCL default group (created once:
# new_group is itself a collective every rank enters in the same order)
_HOST_GROUPS: Dict[object, object] = {}


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_seed(seed: int, rank: int, step: int = 0) -> int:
    """The seed of rank ``rank``'s generators at ``step``: the run's own seed
    for rank 0 at step 0 (a one-rank world repeats the one-process run),
    else a hash of the three (JAX folds the axis index into the key)."""
    if rank == 0 and step == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), rank, step]).generate_state(1)[0])


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def all_reduce_(tensors: Sequence[torch.Tensor], group=None,
                op=dist.ReduceOp.SUM) -> None:
    """Reduce ``tensors`` in place over ``group``: one collective on one
    flat buffer per dtype (one in all for a list of one dtype)."""
    for same in _by_dtype(tensors):
        flat = _flatten_dense_tensors(same)
        dist.all_reduce(flat, op=op, group=group)
        for t, r in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(r)


def broadcast_module_(model: nn.Module, src: int = 0, group=None) -> None:
    """Every parameter and buffer of ``model`` from rank ``src``, one
    broadcast per dtype."""
    with torch.no_grad():
        for same in _by_dtype([*model.parameters(), *model.buffers()]):
            flat = _flatten_dense_tensors(same)
            dist.broadcast(flat, src, group=group)
            for t, r in zip(same, _unflatten_dense_tensors(flat, same)):
                t.copy_(r)


@dataclasses.dataclass(frozen=True)
class World:
    """The joined group as one rank sees it.

    ``group`` carries the tensors on ``device`` (the default group);
    ``host_group`` carries CPU tensors (the default group itself under gloo,
    a gloo group beside NCCL).
    """

    device: torch.device
    rank: int
    size: int
    group: object
    host_group: object

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any (a host all-reduce MAX)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def span(self, value: int) -> Tuple[int, int]:
        """The least and the largest ``value`` over the ranks (one host all-reduce MAX)."""
        t = torch.tensor([int(value), -int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return -int(t[1]), int(t[0])

    def barrier(self) -> None:
        """Wait for every rank: an all-reduce of one host value."""
        dist.all_reduce(torch.zeros(1, dtype=torch.int32), group=self.host_group)


def ensure_distributed(device: DeviceLike = "cuda") -> World:
    """Join the process group (unless this process already opened one) and
    return this rank's :class:`World`.

    The group comes from ``torchrun``'s environment: backend NCCL for a
    CUDA ``device``, gloo for the CPU, each collective timing out after
    ``TIMEOUT``.  A bare ``cuda`` means ``cuda:LOCAL_RANK``; an indexed card
    is taken as given (two ranks on one card).  Without that environment it
    raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if not dist.is_available():
        raise RuntimeError("distributed training needs torch.distributed, which this "
                           "PyTorch build lacks")
    if not dist.is_initialized():
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"distributed training needs torchrun's environment ({', '.join(missing)} "
                "unset): launch it as `torchrun --nproc-per-node N -m "
                "vision_semantic_segmentation_tpu_torch train --distributed ...`")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", timeout=TIMEOUT)
    default = dist.group.WORLD
    if dist.get_backend() == "gloo":
        host = default
    else:
        if default not in _HOST_GROUPS:
            _HOST_GROUPS[default] = dist.new_group(backend="gloo", timeout=TIMEOUT)
        host = _HOST_GROUPS[default]
    return World(dev, dist.get_rank(), dist.get_world_size(), default, host)
