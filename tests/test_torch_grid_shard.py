"""Port parity: the row-sharded grid (``parallel/grid_shard.py``) against
the JAX package's.

The same numpy frame (``tests/test_mapping.py::make_frame``: world-frame
points over a 400x400 grid, the lane boost on, the configuration's evidence
matrix) goes through the JAX ``make_sharded_step`` on its 8-device CPU mesh
and through the port's on 8 logical ``cpu`` shards (one device repeated;
on the CPU every kernel wrapper runs its plain version).  Tolerances:
against the JAX package atol 1e-5 (the fold's sums in another order);
against the port's own single-device ``engine.step`` the JAX tests' atol
1e-4, and every case here is in fact equal bit for bit (asserted: a band
runs the engine's own update on the cells it owns).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.mapping import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.parallel import create_mesh as j_create_mesh
from vision_semantic_segmentation_tpu.parallel import gather_grid as j_gather_grid
from vision_semantic_segmentation_tpu.parallel import init_sharded_grid as j_init_sharded_grid
from vision_semantic_segmentation_tpu.parallel import make_sharded_step as j_make_sharded_step
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine, pad_points
from vision_semantic_segmentation_tpu_torch.parallel import (
    ShardedGrid,
    create_mesh,
    gather_grid,
    init_sharded_grid,
    make_band_updater,
    make_sharded_step,
    shard_grid,
)

from test_mapping import make_frame, small_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ATOL_JAX = 1e-5
SHARDS = 8


def _cfg(fold="matmul", window=0, sort="bitonic"):
    cfg = small_cfg()
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.MAPPING.FOLD_METHOD = fold
    cfg.MAPPING.SORT_METHOD = sort
    cfg.MAPPING.UPDATE_WINDOW = window
    assert cfg.MAPPING.PCD.USE_INTENSITY  # lane boost on
    return cfg


def _frame(seed, cfg, weighted=False):
    rng = np.random.default_rng(seed)
    pts, img, position, quaternion = make_frame(rng, cfg, n=2000)
    # duplicates: some points land twice in one cell with one label
    pts = np.concatenate([pts, pts[:, :300]], axis=1)
    pcd, valid = pad_points(pts, cfg.MAPPING.POINT_BUCKET)
    frame = [pcd, valid, img, position.astype(np.float32), quaternion.astype(np.float32)]
    if weighted:
        frame.append(rng.uniform(0.2, 1.0, cfg.MAPPING.POINT_BUCKET).astype(np.float32))
    return frame


def _jax_sharded(cfg, semantics, frame):
    engine = JaxEngine(cfg, duplicate_semantics=semantics)
    mesh = j_create_mesh(axis_names=("grid",), devices=jax.devices())
    step = j_make_sharded_step(engine, mesh, confidence_weighting=len(frame) == 6)
    grid = step(j_init_sharded_grid(engine, mesh), *(jnp.asarray(a) for a in frame))
    return np.asarray(j_gather_grid(grid))


def _port_sharded(cfg, semantics, frame):
    engine = SemanticMappingEngine(cfg, duplicate_semantics=semantics, device="cpu")
    mesh = create_mesh(axis_names=("grid",), devices=["cpu"] * SHARDS)
    step = make_sharded_step(engine, mesh, confidence_weighting=len(frame) == 6)
    grid = step(init_sharded_grid(engine, mesh), *frame)
    assert isinstance(grid, ShardedGrid) and len(grid.bands) == SHARDS
    return gather_grid(grid)


def _port_unsharded(cfg, semantics, frame):
    """The single-device update: ``engine.step``, or with weights the
    engine's pointwise and update closures (as the JAX tests do)."""
    engine = SemanticMappingEngine(cfg, duplicate_semantics=semantics, device="cpu")
    if len(frame) == 5:
        return engine.step(engine.init_grid(), *frame)[0]
    pcd, valid, img, position, quaternion, weights = (torch.as_tensor(a) for a in frame)
    cell, cls, vis, upd = engine._build_pointwise("camera1", False)(
        pcd, valid, img, position, quaternion)
    return engine._build_update()(engine.init_grid(), cell, cls, pcd[3], upd, weights=weights)


def _check(cfg, semantics, frame):
    got = _port_sharded(cfg, semantics, frame)
    want = _port_unsharded(cfg, semantics, frame)
    assert float(want.sum()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # bit for bit
    np.testing.assert_allclose(got.numpy(), _jax_sharded(cfg, semantics, frame),
                               atol=ATOL_JAX, rtol=0)


@pytest.mark.parametrize("semantics", ["reference", "accumulate"])
@pytest.mark.parametrize("sort", ["bitonic", "radix"])
@pytest.mark.parametrize("fold", ["matmul", "scatter"])
def test_step_matches_jax(fold, sort, semantics):
    """The per-band update against each of the JAX package's four
    fold/sort forms, in both duplicate semantics."""
    cfg = _cfg(fold, sort=sort)
    _check(cfg, semantics, _frame(3, cfg))


@pytest.mark.parametrize("semantics", ["reference", "accumulate"])
def test_windowed_step_matches_jax(semantics):
    """``UPDATE_WINDOW`` 96 over bands of 50 rows: the global window's slab
    straddles several bands, each updates its intersection."""
    cfg = _cfg(window=96)
    _check(cfg, semantics, _frame(4, cfg))


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("semantics", ["reference", "accumulate"])
def test_confidence_weighted_step_matches_jax(semantics, window):
    cfg = _cfg(window=window)
    _check(cfg, semantics, _frame(5, cfg, weighted=True))


def test_unit_weights_reduce_to_unweighted():
    cfg = _cfg()
    frame = _frame(6, cfg, weighted=True)
    frame[5] = np.ones_like(frame[5])
    got = _port_sharded(cfg, "reference", frame)
    torch.testing.assert_close(got, _port_unsharded(cfg, "reference", frame[:5]), rtol=0, atol=0)


def test_layout_and_gather():
    """Bands of rows, each its own contiguous tensor on its shard's device;
    the gather, the copy of a full grid into bands and a band-wise add."""
    engine = SemanticMappingEngine(_cfg(), device="cpu")
    mesh = create_mesh(axis_names=("grid",), devices=["cpu"] * SHARDS)
    fresh = init_sharded_grid(engine, mesh)
    assert fresh.shape == (5, 400, 400)
    assert [tuple(b.shape) for b in fresh.bands] == [(5, 50, 400)] * SHARDS
    assert all(b.is_contiguous() for b in fresh.bands)
    assert len({b.data_ptr() for b in fresh.bands}) == SHARDS
    full = torch.rand((5, 400, 400), generator=torch.Generator().manual_seed(0))
    sharded = shard_grid(full, mesh)
    torch.testing.assert_close(sharded.bands[3], full[:, 150:200], rtol=0, atol=0)
    torch.testing.assert_close(gather_grid(sharded), full, rtol=0, atol=0)
    sharded.bands[0].zero_()
    assert float(full[:, :50].sum()) > 0  # the bands are copies
    torch.testing.assert_close(fresh.add_(full).gather(), full, rtol=0, atol=0)


def test_rows_must_divide_into_the_shards():
    """400 rows do not split into 3 bands: the JAX assertion's words, raised."""
    cfg = _cfg()
    j_mesh = j_create_mesh(axis_names=("grid",), devices=jax.devices()[:3])
    with pytest.raises(AssertionError, match="grid rows 400 must divide into 3 shards") as j_err:
        j_make_sharded_step(JaxEngine(cfg), j_mesh)
    engine = SemanticMappingEngine(cfg, device="cpu")
    mesh = create_mesh(axis_names=("grid",), devices=["cpu"] * 3)
    with pytest.raises(ValueError) as err:
        make_sharded_step(engine, mesh)
    assert str(err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="must divide"):
        init_sharded_grid(engine, mesh)
    with pytest.raises(ValueError, match="must divide"):
        make_band_updater(engine, 3)


def test_full_route_band_shapes():
    """The full-route 5000x7000 grid (ref README.md:173-177) in 8 bands of
    (5, 625, 7000), and one windowed step that densifies no H*W buffer
    (port only: the JAX package runs its own, and two 700 MB grids in one
    test worker are too many)."""
    cfg = get_cfg_defaults()
    cfg.MAPPING.BOUNDARY = [[0, 1000], [0, 1400]]
    cfg.MAPPING.RESOLUTION = 0.2
    cfg.MAPPING.POINT_BUCKET = 4096
    cfg.MAPPING.UPDATE_WINDOW = 512
    engine = SemanticMappingEngine(cfg, device="cpu")
    assert engine.grid_spec.shape[:2] == (5000, 7000)
    mesh = create_mesh(axis_names=("grid",), devices=["cpu"] * SHARDS)
    grid = init_sharded_grid(engine, mesh)
    assert [tuple(b.shape) for b in grid.bands] == [(5, 625, 7000)] * SHARDS
    # a frame whose points land inside this grid's boundary
    small = get_cfg_defaults()
    small.MAPPING.BOUNDARY = [[100, 140], [800, 840]]
    pts, img, position, quaternion = make_frame(np.random.default_rng(7), small, n=2000)
    pcd, valid = pad_points(pts, cfg.MAPPING.POINT_BUCKET)
    grid = make_sharded_step(engine, mesh)(grid, pcd, valid, img, position, quaternion)
    sums = [float(b.sum()) for b in grid.bands]
    # x in [100, 140) m of the boundary at 0.2 m: rows 500-700, in bands 0 and 1
    assert sums[0] > 0 and sums[1] > 0 and sum(sums[2:]) == 0
