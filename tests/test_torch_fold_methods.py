"""Port parity: the engine's update under every ``MAPPING.FOLD_METHOD`` x
``SORT_METHOD`` name against the JAX engine's same-named form.

The port runs one update (the dense mark plus K2) for every name; the JAX
package runs a distinct program for each.  The same numpy frames (with
duplicate points and the lane boost on) go through both packages on the
CPU.  Grids agree to 1e-5 absolute (f32 sums taken in another order: the
port adds E[c, i] * obs[i] term by term where JAX's 'matmul' adds E @ obs
and its 'scatter' totals each cell's evidence columns with segmented
scans) and the sets of nonzero cells are equal.  Within the port every
name gives the default's grid bit for bit, and a run repeats bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.mapping import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine, pad_points

from test_mapping import make_frame, small_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_FRAMES = 3
ATOL = 1e-5


def _cfg(fold, sort, window=0):
    cfg = small_cfg()
    cfg.MAPPING.FOLD_METHOD = fold
    cfg.MAPPING.SORT_METHOD = sort
    cfg.MAPPING.UPDATE_WINDOW = window
    assert cfg.MAPPING.PCD.USE_INTENSITY  # lane boost on
    return cfg


def _frames(seed, cfg):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_FRAMES):
        pts, img, position, quaternion = make_frame(rng, cfg, n=3000)
        # duplicates: some points land twice in one cell with one label
        pts = np.concatenate([pts, pts[:, :500]], axis=1)
        pcd, valid = pad_points(pts, cfg.MAPPING.POINT_BUCKET)
        out.append((pcd, valid, img, position.astype(np.float32), quaternion.astype(np.float32)))
    return out


def _assert_grids_match(ours: torch.Tensor, ref) -> None:
    ours, ref = ours.numpy(), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours != 0, ref != 0)
    assert (ref != 0).any()


def _port_grid(cfg, dedupe, frames):
    engine = SemanticMappingEngine(cfg, duplicate_semantics=dedupe, device="cpu")
    grid = engine.init_grid()
    for pcd, valid, img, position, quaternion in frames:
        grid, _, _ = engine.step(grid, pcd, valid, img, position, quaternion)
    return grid


@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
@pytest.mark.parametrize("sort", ["bitonic", "radix"])
@pytest.mark.parametrize("fold", ["matmul", "scatter"])
def test_step_matches_jax(fold, sort, dedupe):
    cfg = _cfg(fold, sort)
    frames = _frames(11, cfg)
    j_engine = JaxEngine(cfg, duplicate_semantics=dedupe)
    j_grid = j_engine.init_grid()
    for pcd, valid, img, position, quaternion in frames:
        j_grid, _, _ = j_engine.step(j_grid, pcd, valid, img, position, quaternion)
    _assert_grids_match(_port_grid(cfg, dedupe, frames), j_grid)


@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
@pytest.mark.parametrize("sort", ["bitonic", "radix"])
@pytest.mark.parametrize("fold", ["matmul", "scatter"])
def test_update_window_matches_jax(fold, sort, dedupe):
    cfg = _cfg(fold, sort, window=200)
    frames = _frames(12, cfg)
    j_engine = JaxEngine(cfg, duplicate_semantics=dedupe)
    j_grid = j_engine.init_grid()
    for pcd, valid, img, position, quaternion in frames:
        j_grid, _, _ = j_engine.step(j_grid, pcd, valid, img, position, quaternion)
    _assert_grids_match(_port_grid(cfg, dedupe, frames), j_grid)


@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
@pytest.mark.parametrize("sort", ["bitonic", "radix"])
@pytest.mark.parametrize("fold", ["matmul", "scatter"])
def test_confidence_weights_match_jax(fold, sort, dedupe):
    """The update with per-point confidence weights (the fused pipeline's
    confidence weighting): a deduped hit carries its strongest point's
    weight, per-point mode sums them."""
    cfg = _cfg(fold, sort)
    frames = _frames(13, cfg)
    rng = np.random.default_rng(14)
    j_engine = JaxEngine(cfg, duplicate_semantics=dedupe)
    t_engine = SemanticMappingEngine(cfg, duplicate_semantics=dedupe, device="cpu")
    j_point, j_update = j_engine._build_pointwise("camera1", False), jax.jit(j_engine._build_update())
    t_point, t_update = t_engine._build_pointwise("camera1", False), t_engine._build_update()
    j_grid, t_grid = j_engine.init_grid(), t_engine.init_grid()
    for pcd, valid, img, position, quaternion in frames:
        weights = rng.uniform(0.2, 1.0, pcd.shape[1]).astype(np.float32)
        cell, cls, _, upd, _ = j_point(jnp.asarray(pcd), jnp.asarray(valid), jnp.asarray(img),
                                       jnp.asarray(position), jnp.asarray(quaternion))
        j_grid = j_update(j_grid, cell, cls, jnp.asarray(pcd[3]), upd,
                          weights=jnp.asarray(weights))
        tc, tk, _, tu = t_point(torch.from_numpy(pcd), torch.from_numpy(valid),
                                torch.from_numpy(img), torch.from_numpy(position),
                                torch.from_numpy(quaternion))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(cell))
        t_grid = t_update(t_grid, tc, tk, torch.from_numpy(pcd[3]), tu,
                          weights=torch.from_numpy(weights))
    _assert_grids_match(t_grid, j_grid)


@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
def test_every_fold_and_sort_name_gives_one_grid(dedupe):
    """Each name's run (the default's a second time) equals the default's
    first run bit for bit, so every name gives one grid and repeats."""
    frames = _frames(15, _cfg("matmul", "bitonic"))
    default = _port_grid(_cfg("matmul", "bitonic"), dedupe, frames)
    assert float(default.sum()) > 0
    for fold in ("matmul", "scatter"):
        for sort in ("bitonic", "radix"):
            assert torch.equal(_port_grid(_cfg(fold, sort), dedupe, frames), default), (fold, sort)


@pytest.mark.parametrize("key,value", [("FOLD_METHOD", "dense"), ("SORT_METHOD", "quick")])
def test_unknown_names_raise(key, value):
    cfg = small_cfg()
    setattr(cfg.MAPPING, key, value)
    frame = _frames(16, cfg)[0]
    with pytest.raises(ValueError, match=value):
        JaxEngine(cfg).step(JaxEngine(cfg).init_grid(), *frame)
    engine = SemanticMappingEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match=value):
        engine.step(engine.init_grid(), *frame)


class _Update(torch.nn.Module):
    def __init__(self, engine):
        super().__init__()
        self.update = engine._build_update()

    def forward(self, grid, cell, cls, intensity, upd):
        return self.update(grid, cell, cls, intensity, upd)


def test_windowed_update_traces_without_host_sync():
    """``torch.export`` refuses a data-dependent shape or a read back to the
    host: the windowed update traces, and the traced update equals the
    eager one."""
    cfg = _cfg("matmul", "bitonic", window=200)
    engine = SemanticMappingEngine(cfg, device="cpu")
    pcd, valid, img, position, quaternion = _frames(17, cfg)[0]
    cell, cls, _, upd = engine._build_pointwise("camera1", False)(
        torch.from_numpy(pcd), torch.from_numpy(valid), torch.from_numpy(img),
        torch.from_numpy(position), torch.from_numpy(quaternion))
    args = (engine.init_grid(), cell, cls, torch.from_numpy(pcd[3]), upd)
    program = torch.export.export(_Update(engine), args, strict=False)
    want = engine._build_update()(engine.init_grid(), *args[1:])
    got = program.module()(engine.init_grid(), *args[1:])
    assert torch.equal(got, want) and float(want.sum()) > 0
