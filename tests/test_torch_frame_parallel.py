"""Port parity: frame-parallel replay (``parallel/frame_parallel.py``) and
its composition with the row-sharded grid against the JAX package's.

The same numpy frames (``tests/test_mapping.py::make_frame``: world-frame
points over a 400x400 grid, the lane boost on, the configuration's evidence
matrix) go through the JAX ``make_frame_parallel_run`` /
``make_sharded_frame_parallel_run`` on its 8-device CPU mesh and through
the port's on 8 logical ``cpu`` shards.  Tolerances: against the JAX
package atol 1e-5 (the fold's sums and the psum in another order); against
the port's own sequential ``engine.step`` loop the JAX tests' rtol 1e-5 and
atol 1e-5 (the shards' partial sums re-associate the per-frame adds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.mapping import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.parallel import create_mesh as j_create_mesh
from vision_semantic_segmentation_tpu.parallel import init_sharded_grid as j_init_sharded_grid
from vision_semantic_segmentation_tpu.parallel import (
    make_frame_parallel_run as j_make_frame_parallel_run,
    make_sharded_frame_parallel_run as j_make_sharded_frame_parallel_run,
    stack_frames as j_stack_frames,
)
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine, pad_points
from vision_semantic_segmentation_tpu_torch.parallel import (
    create_mesh,
    init_sharded_grid,
    make_frame_parallel_run,
    make_sharded_frame_parallel_run,
    stack_frames,
)
from vision_semantic_segmentation_tpu_torch.runtime.io import FrameRecord

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
    return cfg


def _frames(seed, cfg, n_frames=8):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        pts, img, position, quaternion = make_frame(rng, cfg, n=1000)
        frames.append(FrameRecord(pcd=pts, pcd_frame_id="world", semantic_image=img,
                                  position=position, quaternion=quaternion, stamp=float(i)))
    return frames


def _sequential(engine, frames):
    grid = engine.init_grid()
    for f in frames:
        pcd, valid = pad_points(f.pcd, engine.point_bucket)
        grid, _, _ = engine.step(grid, pcd, valid, f.semantic_image, f.position, f.quaternion)
    return grid


def _jax_run(cfg, frames):
    engine = JaxEngine(cfg)
    mesh = j_create_mesh(axis_names=("data",), devices=jax.devices())
    run = j_make_frame_parallel_run(engine, mesh)
    return np.asarray(run(engine.init_grid(), *j_stack_frames(engine, frames, mesh)))


def _check(got, want, j_grid):
    assert float(want.sum()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), j_grid, atol=ATOL_JAX, rtol=0)


@pytest.mark.parametrize("fold,sort,window", [("matmul", "bitonic", 0), ("scatter", "bitonic", 0),
                                              ("scatter", "radix", 0), ("matmul", "bitonic", 96)])
def test_run_matches_jax(fold, sort, window):
    """Plain, against the JAX package's 'scatter' forms under both sorts
    (the port runs its one update for every name), and ``UPDATE_WINDOW`` 96
    honoured in each shard's partial grid."""
    cfg = _cfg(fold, window, sort)
    frames = _frames(1, cfg)
    engine = SemanticMappingEngine(cfg, device="cpu")
    mesh = create_mesh(axis_names=("data",), devices=["cpu"] * SHARDS)
    grid = engine.init_grid()
    got = make_frame_parallel_run(engine, mesh)(grid, *stack_frames(engine, frames, mesh))
    assert got is grid  # the grid gains the sum in place
    want = _sequential(SemanticMappingEngine(_cfg(window=window), device="cpu"), frames)
    _check(got, want, _jax_run(cfg, frames))


def test_padding_frames_are_noops():
    """5 frames pad to 8 with no-op frames; 3 shards pad 8 frames to 9."""
    cfg = _cfg()
    frames = _frames(2, cfg, n_frames=5)
    engine = SemanticMappingEngine(cfg, device="cpu")
    mesh = create_mesh(axis_names=("data",), devices=["cpu"] * SHARDS)
    stacked = stack_frames(engine, frames, mesh)
    j_stacked = j_stack_frames(JaxEngine(cfg), frames,
                               j_create_mesh(axis_names=("data",), devices=jax.devices()))
    assert [tuple(t.shape) for t in stacked] == [tuple(a.shape) for a in j_stacked]
    assert stacked[0].shape[0] == 8
    for ours, ref in zip(stacked, j_stacked):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not stacked[1][5:].any() and not stacked[2][5:].any()
    np.testing.assert_array_equal(stacked[4][5:].numpy(), [[0, 0, 0, 1]] * 3)
    got = make_frame_parallel_run(engine, mesh)(engine.init_grid(), *stacked)
    _check(got, _sequential(engine, frames), _jax_run(cfg, frames))

    frames = _frames(3, cfg)
    mesh3 = create_mesh(axis_names=("data",), devices=["cpu"] * 3)
    stacked = stack_frames(engine, frames, mesh3)
    assert stacked[0].shape[0] == 9
    got = make_frame_parallel_run(engine, mesh3)(engine.init_grid(), *stacked)
    _check(got, _sequential(engine, frames), _jax_run(cfg, frames))


@pytest.mark.parametrize("window", [0, 96])
def test_confidence_weighted_run_matches_jax(window):
    cfg = _cfg(window=window)
    frames = _frames(4, cfg)
    rng = np.random.default_rng(40)
    weights = rng.uniform(0.2, 1.0, (len(frames), cfg.MAPPING.POINT_BUCKET)).astype(np.float32)

    engine = SemanticMappingEngine(cfg, device="cpu")
    pointwise, update = engine._build_pointwise("camera1", False), engine._build_update()
    want = engine.init_grid()
    for f, w in zip(frames, weights):
        pcd, valid = pad_points(f.pcd, cfg.MAPPING.POINT_BUCKET)
        pcd = torch.from_numpy(pcd)
        cell, cls, vis, upd = pointwise(
            pcd, torch.from_numpy(valid), torch.from_numpy(f.semantic_image),
            torch.as_tensor(f.position, dtype=torch.float32),
            torch.as_tensor(f.quaternion, dtype=torch.float32))
        update(want, cell, cls, pcd[3], upd, weights=torch.from_numpy(w))

    mesh = create_mesh(axis_names=("data",), devices=["cpu"] * SHARDS)
    run = make_frame_parallel_run(engine, mesh, confidence_weighting=True)
    got = run(engine.init_grid(), *stack_frames(engine, frames, mesh), weights)
    with pytest.raises(TypeError, match="weights"):
        run(engine.init_grid(), *stack_frames(engine, frames, mesh))

    j_engine = JaxEngine(cfg)
    j_mesh = j_create_mesh(axis_names=("data",), devices=jax.devices())
    j_run = j_make_frame_parallel_run(j_engine, j_mesh, confidence_weighting=True)
    j_grid = j_run(j_engine.init_grid(), *j_stack_frames(j_engine, frames, j_mesh),
                   jnp.asarray(weights))
    _check(got, want, np.asarray(j_grid))


def test_composed_run_matches_jax():
    """Frames over 4 'data' shards, grid rows over 2 'grid' shards, one psum
    per band."""
    cfg = _cfg()
    frames = _frames(5, cfg)
    engine = SemanticMappingEngine(cfg, device="cpu")
    mesh = create_mesh(axis_sizes=(4, 2), axis_names=("data", "grid"), devices=["cpu"] * 8)
    grid = init_sharded_grid(engine, mesh)
    assert [tuple(b.shape) for b in grid.bands] == [(5, 200, 400)] * 2
    got = make_sharded_frame_parallel_run(engine, mesh)(grid, *stack_frames(engine, frames, mesh))
    assert got is grid

    j_engine = JaxEngine(cfg)
    j_mesh = j_create_mesh(axis_sizes=(4, 2), axis_names=("data", "grid"),
                           devices=jax.devices())
    j_run = j_make_sharded_frame_parallel_run(j_engine, j_mesh)
    j_grid = j_run(j_init_sharded_grid(j_engine, j_mesh),
                   *j_stack_frames(j_engine, frames, j_mesh))
    _check(got.gather(), _sequential(engine, frames), np.asarray(j_grid))


def test_frames_must_split_over_the_shards():
    cfg = _cfg()
    engine = SemanticMappingEngine(cfg, device="cpu")
    mesh = create_mesh(axis_names=("data",), devices=["cpu"] * 4)
    stacked = stack_frames(engine, _frames(6, cfg, n_frames=2), create_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="does not split into 4 shards"):
        make_frame_parallel_run(engine, mesh)(engine.init_grid(), *stacked)
    with pytest.raises(ValueError, match="empty frame sequence"):
        stack_frames(engine, [], mesh)
