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

Bands across ranks (``TRAIN.SPATIAL_SHARDS`` S under ``train
--distributed``): :meth:`World.spatial_groups` places rank r at band
``r % S`` of data group ``r // S``, so consecutive ranks share one image's
rows, and opens two subgroups beside the world: the S ranks of its image
(the halo exchanges, ASPP's pooled sums) and the ranks holding its band
index, one a data group (BatchNorm over ASPP's pooled vectors, which every
band of an image holds a copy of).  :class:`Traffic` counts what the bands'
collectives did, so a step can check that every rank made the same ones.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import time
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
# the subgroups of bands across ranks, by default group and band count
_SPATIAL_GROUPS: Dict[Tuple[object, int], "SpatialGroups"] = {}


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

    def spatial_groups(self, shards: int) -> "SpatialGroups":
        """This rank's place in bands across ranks: band ``rank % shards`` of
        data group ``rank // shards``.

        Every rank opens every subgroup, in one order (``new_group`` is
        itself a collective), once per world and band count.  A band count
        that does not divide the world raises ``ValueError`` on every rank
        before any collective (the JAX trainer's device-count check).
        """
        if shards < 1 or self.size % shards:
            raise ValueError(f"TRAIN.SPATIAL_SHARDS={shards} does not divide the world of "
                             f"{self.size} ranks")
        key = (self.group, shards)
        if key not in _SPATIAL_GROUPS:
            spatial = data = None
            for g in range(self.size // shards):
                ranks = list(range(g * shards, (g + 1) * shards))
                made = dist.new_group(ranks, timeout=TIMEOUT)
                spatial = made if self.rank in ranks else spatial
            for b in range(shards):
                ranks = list(range(b, self.size, shards))
                made = dist.new_group(ranks, timeout=TIMEOUT)
                data = made if self.rank in ranks else data
            _SPATIAL_GROUPS[key] = SpatialGroups(
                self, shards, self.rank % shards, self.rank // shards, self.size // shards,
                spatial, data, dist.get_backend(spatial))
        return _SPATIAL_GROUPS[key]


class Traffic:
    """What the collectives of bands across ranks did on this rank: calls by
    kind (``exchange`` and ``exchange_backward`` for halos, ``all_reduce``
    for sums), the halo bytes sent, and, with ``timed``, the seconds spent
    in each kind (the card synchronised before and after each call, so the
    time is the call's own, not the work queued before it)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self.bytes_sent = 0

    @contextlib.contextmanager
    def record(self, kind: str, device: torch.device):
        self.calls[kind] += 1
        if not self.timed:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds[kind] += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class SpatialGroups:
    """Bands across ranks as one rank sees them (:meth:`World.spatial_groups`).

    ``spatial`` holds the ``shards`` ranks of this rank's image, in band
    order (global ranks ``data * shards + b``); ``data_group`` the ranks
    holding band ``band``, one a data group; ``backend`` is the spatial
    group's (gloo stages halos of CUDA tensors through host memory).
    """

    world: World
    shards: int
    band: int
    data: int
    data_groups: int
    spatial: object
    data_group: object
    backend: str
    traffic: Traffic = dataclasses.field(default_factory=Traffic, compare=False)

    def peer(self, band: int) -> int:
        """The global rank holding band ``band`` of this rank's image."""
        return self.data * self.shards + band

    def check_calls(self) -> None:
        """Raise unless every rank has made as many collective calls of bands
        as this one (one host all-reduce).  Every rank's graph makes the same
        calls in one order; a rank whose graph skipped one shows here."""
        low, high = self.world.span(sum(self.traffic.calls.values()))
        if low != high:
            raise RuntimeError(f"the ranks made {low} to {high} collective calls of bands: "
                               "their graphs diverged")


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
