"""Port parity: the device mesh and its splits (``parallel/mesh.py``)
against the JAX package's, and the kernels' launch on their tensors' card.

The port's mesh is one process driving a ``torch.device`` array; here it
holds 8 logical ``cpu`` shards (one device repeated), beside the JAX
package's virtual 8-device CPU mesh.  Each split's pieces equal, in the
mesh's device order, the ``addressable_shards`` of the JAX array placed
with the same sharding, bit for bit.
"""
import types

import jax
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.parallel import mesh as j_mesh
from vision_semantic_segmentation_tpu_torch.ops.kernels import _lib
from vision_semantic_segmentation_tpu_torch.parallel import mesh

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

MESHES = [((8,), ("data",)), ((4, 2), ("data", "grid")), ((2, 4), ("data", "spatial")),
          ((2, 2, 2), ("data", "grid", "spatial"))]


def _meshes(sizes, names):
    return (mesh.create_mesh(sizes, names, devices=["cpu"] * 8),
            j_mesh.create_mesh(sizes, names, devices=jax.devices()))


def _jax_pieces(jm, array):
    """The array's addressable shards in the mesh's device order."""
    order = {d.id: i for i, d in enumerate(jm.devices.flat)}
    shards = sorted(array.addressable_shards, key=lambda s: order[s.device.id])
    return [np.asarray(s.data) for s in shards]


def _assert_pieces(ours, jm, ref):
    assert len(ours) == 8
    for piece, want in zip(ours, _jax_pieces(jm, ref)):
        assert piece.device == torch.device("cpu") and piece.is_contiguous()
        np.testing.assert_array_equal(piece.numpy(), want)


@pytest.mark.parametrize("sizes,names", MESHES)
def test_mesh_shape(sizes, names):
    m, jm = _meshes(sizes, names)
    assert m.shape == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names) and m.size == jm.size == 8
    assert m.devices.shape == sizes
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh.create_mesh(axis_names=names, devices=["cpu"] * 8).shape == dict(
        j_mesh.create_mesh(axis_names=names, devices=jax.devices()).shape)


def test_mesh_defaults_and_refusals():
    default = mesh.create_mesh(device_type="cpu")
    assert default.shape == {"data": 1} and list(default.devices.flat) == [torch.device("cpu")]
    with pytest.raises(ValueError, match=r"mesh \(3,\) != 8 devices"):
        mesh.create_mesh((3,), devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.create_mesh()
    m = mesh.create_mesh((2, 2, 2), ("data", "grid", "spatial"), devices=["cpu"] * 8)
    sub = m.submesh("grid", "data")
    assert sub.shape == {"grid": 2, "data": 2} and len(m.along("spatial")) == 2


@pytest.mark.parametrize("sizes,names", MESHES)
def test_shard_batch_pieces(sizes, names):
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((8, 6, 4, 3)).astype(np.float32),
             "label": rng.integers(0, 19, (8, 6, 4)).astype(np.int32)}
    m, jm = _meshes(sizes, names)
    ours = mesh.shard_batch(m, batch)
    ref = j_mesh.shard_batch(jm, batch)
    for key in batch:
        _assert_pieces(ours[key], jm, ref[key])
    # pieces of one block on one device are one tensor
    assert len({p.data_ptr() for p in ours["image"]}) == sizes[0]


@pytest.mark.parametrize("sizes,names", MESHES[:2])
def test_shard_stacked_batches_pieces(sizes, names):
    batches = [np.arange(3 * 8 * 5, dtype=np.float32).reshape(3, 8, 5)]
    m, jm = _meshes(sizes, names)
    (ours,), (ref,) = mesh.shard_stacked_batches(m, batches), j_mesh.shard_stacked_batches(
        jm, batches)
    _assert_pieces(ours, jm, ref)
    assert ours[0].shape == (3, 8 // sizes[0], 5)


@pytest.mark.parametrize("steps_axis", [False, True])
@pytest.mark.parametrize("data_axis", ["data", None])
def test_shard_spatial_batch_pieces(data_axis, steps_axis):
    shape = ((2,) if steps_axis else ()) + (2, 8, 12, 3)
    batch = {"image": np.random.default_rng(1).random(shape).astype(np.float32)}
    m, jm = _meshes((2, 4), ("data", "spatial"))
    ours = mesh.shard_spatial_batch(m, batch, data_axis=data_axis, steps_axis=steps_axis)
    ref = j_mesh.shard_spatial_batch(jm, batch, data_axis=data_axis, steps_axis=steps_axis)
    _assert_pieces(ours["image"], jm, ref["image"])


def test_partition_specs():
    m, jm = _meshes((4, 2), ("data", "grid"))
    for name in ("data_sharding", "grid_row_sharding", "replicated"):
        ours, ref = getattr(mesh, name)(m), getattr(j_mesh, name)(jm)
        assert tuple(ours.spec) == tuple(ref.spec) and ours.mesh is m


def test_psum_fixed_order():
    """Shard 0 first, then 1, and so on; every shard of a group holds its
    sum, shards of a group on one device share one tensor, the inputs stay."""
    m = mesh.create_mesh((4, 2), ("data", "grid"), devices=["cpu"] * 8)
    # along 'data' at grid 0: 1e8, -1e8, 3, 7, whose f32 sum is 10 in this
    # order only (1e8 + 3 rounds to 1e8)
    vals = np.float32([1e8, 1.0, -1e8, 1.0, 3.0, 0.5, 7.0, 0.25])
    parts = [torch.full((3,), float(v)) for v in vals]
    out = mesh.psum(m, parts, "data")
    assert isinstance(out, list) and len(out) == 8
    for g, want in ((0, 10.0), (1, 2.75)):
        assert all(out[2 * d + g] is out[g] for d in range(4))
        np.testing.assert_array_equal(out[g].numpy(), [want] * 3)
    np.testing.assert_array_equal(torch.stack(parts)[:, 0].numpy(), vals)
    grid_parts = np.empty((4, 2), dtype=object)
    for i, p in enumerate(parts):
        grid_parts[i // 2, i % 2] = p
    by_grid = mesh.psum(m, grid_parts, "grid")
    assert by_grid.shape == (4, 2)
    for d in range(4):
        assert by_grid[d, 0] is by_grid[d, 1]
        np.testing.assert_array_equal(by_grid[d, 0].numpy(),
                                      [np.float32(vals[2 * d] + vals[2 * d + 1])] * 3)


def test_launch_takes_the_stream_of_its_tensors_card(monkeypatch):
    """A band on ``cuda:1`` launches on ``cuda:1``'s current stream with
    ``cuda:1`` current, whatever card is current (no second card here: the
    CUDA calls are stand-ins)."""
    calls = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            calls.append(("current", self.device))

        def __exit__(self, *exc):
            calls.append(("restored", self.device))

    def current_stream(device=None):
        calls.append(("stream of", device))
        return types.SimpleNamespace(cuda_stream=1000 + device.index)

    def entry_point(*args):
        calls.append(("launch", args[-1].value))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_lib, "_REGISTRY", list(_lib._REGISTRY))  # the stand-in registers
    kernel = _lib.CudaKernel("stand_in", "fold.cu", "stand_in", [])
    monkeypatch.setattr(kernel, "_load", lambda: entry_point)
    card1 = torch.device("cuda", 1)
    band = types.SimpleNamespace(data_ptr=lambda: 4096, device=card1)
    kernel.launch(_lib.ptr(band), _lib.ptr(band), 7)
    assert calls == [("current", card1), ("stream of", card1), ("launch", 1001),
                     ("restored", card1)]
    assert kernel.launches == 1
    other = types.SimpleNamespace(data_ptr=lambda: 8192, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="not one card"):
        kernel.launch(_lib.ptr(band), _lib.ptr(other))
    assert kernel.launches == 1
