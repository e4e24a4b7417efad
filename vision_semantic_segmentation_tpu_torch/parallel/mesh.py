"""The device mesh and its splits, in the single-controller form of
``shard_map``.

Port of ``vision_semantic_segmentation_tpu/parallel/mesh.py``.  One process
drives every device of a mesh: a :class:`Mesh` is an array of
``torch.device`` with named axes (``data`` for frames or batches, ``grid``
for the BEV grid's row bands), a :class:`NamedSharding` splits a tensor
into the pieces that the devices of a ``jax.Array`` with that sharding hold
(``addressable_shards``, in the mesh's device order), and :func:`psum` adds
per-shard tensors over one axis in a fixed order.

A device may repeat: ``create_mesh(devices=["cuda:0"] * 4)`` is four
logical shards on one card, the counterpart of the JAX tests' virtual
8-device CPU mesh.  Their work runs one shard after another on that card,
and pieces that land on one device are one tensor.

No ``torch.distributed`` here: a mesh over several cards is driven from one
process.  Data-parallel training runs one process per card instead
(``parallel/distributed.py``), since its BatchNorm statistics cross the
cards in the middle of every forward and backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class PartitionSpec(tuple):
    """Per leading dimension: a mesh axis name, a tuple of names (split over
    their product, the first name major) or None (not split)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


def _device(d: DeviceLike) -> torch.device:
    """``torch.device`` with a CUDA index (``cuda`` is the current card)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every local device of a type: ``cuda:i`` for each card (raising
    without one), or the one ``cpu``."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device_type)
    return [torch.device(device_type, i) for i in range(torch.cuda.device_count())]


def distinct(devices) -> List[torch.device]:
    """The devices in first-seen order, each once."""
    return list(dict.fromkeys(devices))


class Mesh:
    """``devices``: an object ndarray of ``torch.device``, one array axis
    per name of ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def submesh(self, *axes: str) -> "Mesh":
        """The mesh over ``axes`` in that order, the other axes at index 0
        (their devices would hold replicas)."""
        order = [self.axis_names.index(a) for a in axes]
        rest = tuple(0 if i not in order else slice(None) for i in range(len(self.axis_names)))
        kept = [i for i in range(len(self.axis_names)) if i in order]
        sub = self.devices[rest]
        return Mesh(np.transpose(sub, [kept.index(i) for i in order]), axes)

    def along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at index 0."""
        return list(self.submesh(axis).devices)


def create_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[DeviceLike]] = None,
    device_type: str = "cuda",
) -> Mesh:
    """Build a mesh over ``devices`` (default: every local device of
    ``device_type``).

    Args:
        axis_sizes: size per axis; defaults to all devices on the first axis.
        axis_names: e.g. ('data',) or ('data', 'grid').
        devices: a device may repeat (logical shards on one device).
    """
    devs = [_device(d) for d in devices] if devices is not None else local_devices(device_type)
    if axis_sizes is None:
        axis_sizes = (len(devs),) + (1,) * (len(axis_names) - 1)
    if math.prod(axis_sizes) != len(devs):
        raise ValueError(f"mesh {tuple(axis_sizes)} != {len(devs)} devices")
    array = np.empty(len(devs), dtype=object)
    for i, dev in enumerate(devs):
        array[i] = dev
    return Mesh(array.reshape(tuple(axis_sizes)), axis_names)


class NamedSharding:
    """A partition spec over a mesh; :meth:`shard` splits a tensor by it."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def split(self, x, dtype: Optional[torch.dtype] = None) -> np.ndarray:
        """An object ndarray of the mesh's shape: each device's piece of
        ``x`` (a tensor or an array), on that device.  Pieces of one block
        on one device are one tensor; a piece on ``x``'s own device may be
        a view of ``x``.  Copies to a card do not block the host (from
        pinned memory they are asynchronous)."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if dtype is not None and x.dtype != dtype:
            x = x.to(dtype)
        mesh = self.mesh
        if len(self.spec) > x.ndim:
            raise ValueError(f"spec {self.spec} for a {x.ndim}-d input")
        out = np.empty(mesh.devices.shape, dtype=object)
        made: Dict[Tuple, torch.Tensor] = {}
        for coord in np.ndindex(*mesh.devices.shape):
            at = dict(zip(mesh.axis_names, coord))
            index = []
            for dim, names in enumerate(self.spec):
                if names is None:
                    index.append(slice(None))
                    continue
                names = (names,) if isinstance(names, str) else tuple(names)
                sizes = [mesh.shape[n] for n in names]
                count = math.prod(sizes)
                if x.shape[dim] % count:
                    raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split "
                                     f"into {count} shards over {names}")
                block = int(np.ravel_multi_index([at[n] for n in names], sizes))
                step = x.shape[dim] // count
                index.append(slice(block * step, (block + 1) * step))
            device = mesh.devices[coord]
            key = (tuple((s.start, s.stop) for s in index), device)
            if key not in made:
                made[key] = x[tuple(index)].to(
                    device, non_blocking=device.type == "cuda").contiguous()
            out[coord] = made[key]
        return out

    def shard(self, x, dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """The pieces in the mesh's device order (``addressable_shards``)."""
        return list(self.split(x, dtype).flat)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Batch-dim sharding: leading axis split over the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def grid_row_sharding(mesh: Mesh, axis: str = "grid") -> NamedSharding:
    """BEV grid sharding: rows (the x/boundary axis) split over devices."""
    return NamedSharding(mesh, P(axis))


Tree = Union[torch.Tensor, np.ndarray, dict, list, tuple]


def _tree_map(fn, tree: Tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Tree, axis: str = "data"):
    """Each leaf of a host batch as its per-device pieces, split along the
    leading dim."""
    return _tree_map(data_sharding(mesh, axis).shard, batch)


def shard_stacked_batches(mesh: Mesh, batches: Tree, axis: str = "data"):
    """(K, B, ...) stacked per-step batches: dim 0 = step (not split), dim 1
    = batch (split along ``axis``)."""
    return _tree_map(NamedSharding(mesh, P(None, axis)).shard, batches)


def shard_spatial_batch(
    mesh: Mesh,
    batch: Tree,
    data_axis: Optional[str] = "data",
    spatial_axis: str = "spatial",
    steps_axis: bool = False,
):
    """The batch dim over ``data_axis`` AND image rows over ``spatial_axis``
    (image (B, H, W, C) and label (B, H, W) share one spec: H is dim 1 of
    both).  ``steps_axis``: a leading K (steps-per-dispatch) axis is not
    split."""
    spec = P(None, data_axis, spatial_axis) if steps_axis else P(data_axis, spatial_axis)
    return _tree_map(NamedSharding(mesh, spec).shard, batch)


def psum(mesh: Mesh, parts, axis: str):
    """Sum per-shard tensors over ``axis``, in a fixed order.

    ``parts`` holds one tensor per device of the mesh: an object ndarray of
    the mesh's shape, or a list in the mesh's device order.  Each group
    along ``axis`` adds on its first shard's device, shard 0 first, then 1,
    and so on, so the result does not depend on which device finishes
    first.  Returns the sums in the same form; every shard of a group holds
    its group's sum, and shards of a group on one device share one tensor.
    The inputs are not changed.
    """
    as_list = isinstance(parts, (list, tuple))
    array = np.empty(mesh.devices.shape, dtype=object)
    for i, part in enumerate(parts if as_list else parts.flat):
        array.flat[i] = part
    ax = mesh.axis_names.index(axis)
    groups = np.moveaxis(array, ax, -1)
    devices = np.moveaxis(mesh.devices, ax, -1)
    out = np.empty(groups.shape, dtype=object)
    for idx in np.ndindex(*groups.shape[:-1]):
        home = devices[idx][0]
        total = groups[idx][0].to(home, copy=True)
        for part in groups[idx][1:]:
            total += part.to(home)
        copies = {home: total}
        for k, dev in enumerate(devices[idx]):
            if dev not in copies:
                copies[dev] = total.to(dev)
            out[idx + (k,)] = copies[dev]
    out = np.moveaxis(out, -1, ax)
    return list(out.flat) if as_list else out
