"""Port parity: the mapping engine's frame update against the JAX package.

The same numpy frames go through ``SemanticMappingEngine`` of both packages
on the CPU (the port's fold runs its plain version there).  Grids agree to
1e-5 (the port adds E[c, i] * obs[i] into the grid term by term, the JAX
package adds E @ obs at once) and the set of nonzero cells is identical.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vision_semantic_segmentation_tpu.mapping import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.runtime import io as j_io
from vision_semantic_segmentation_tpu.runtime.replay import MappingReplay as JaxReplay
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine, pad_points
from vision_semantic_segmentation_tpu_torch.runtime import MappingReplay, io

from test_mapping import make_frame, small_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_FRAMES = 3


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
    ours = ours.numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_array_equal(ours != 0, ref != 0)
    assert (ref != 0).any()


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
def test_step_matches_jax(dedupe, window):
    cfg = small_cfg()
    cfg.MAPPING.UPDATE_WINDOW = window
    assert cfg.MAPPING.PCD.USE_INTENSITY  # lane boost on
    j_engine = JaxEngine(cfg, duplicate_semantics=dedupe)
    t_engine = SemanticMappingEngine(cfg, duplicate_semantics=dedupe, device="cpu")
    j_grid = j_engine.init_grid()
    t_grid = t_engine.init_grid()
    for pcd, valid, img, position, quaternion in _frames(11, cfg):
        j_grid, j_cls, j_vis = j_engine.step(j_grid, pcd, valid, img, position, quaternion)
        t_grid, t_cls, t_vis = t_engine.step(t_grid, pcd, valid, img, position, quaternion)
        np.testing.assert_array_equal(t_cls.numpy(), np.asarray(j_cls))
        np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))
    _assert_grids_match(t_grid, j_grid)
    lane = cfg.LABELS_NAMES.index("lane")
    assert float(t_grid[lane].max()) >= 2.0  # the lane boost fired


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("dedupe", ["reference", "accumulate"])
def test_distorted_image_update_matches_jax(dedupe, window):
    """The plumb-bob point path (``distorted_image``) feeding the update."""
    cfg = small_cfg()
    cfg.MAPPING.UPDATE_WINDOW = window
    j_engine = JaxEngine(cfg, duplicate_semantics=dedupe)
    t_engine = SemanticMappingEngine(cfg, duplicate_semantics=dedupe, device="cpu")
    j_pw = j_engine._build_pointwise("camera1", False, distorted_image=True)
    t_pw = t_engine._build_pointwise("camera1", False, distorted_image=True)
    j_update = j_engine._build_update()
    t_update = t_engine._build_update()
    j_grid = j_engine.init_grid()
    t_grid = t_engine.init_grid()
    for pcd, valid, img, position, quaternion in _frames(12, cfg):
        cell, cls, vis, upd, _ = j_pw(jnp.asarray(pcd), jnp.asarray(valid), jnp.asarray(img),
                                      jnp.asarray(position), jnp.asarray(quaternion))
        j_grid = j_update(j_grid, cell, cls, jnp.asarray(pcd[3]), upd)
        t_pcd = torch.from_numpy(pcd)
        cell, cls, vis, upd = t_pw(t_pcd, torch.from_numpy(valid), torch.from_numpy(img),
                                   torch.from_numpy(position), torch.from_numpy(quaternion))
        t_grid = t_update(t_grid, cell, cls, t_pcd[3], upd)
    _assert_grids_match(t_grid, j_grid)


def test_grid_state_roundtrip(tmp_path):
    cfg = small_cfg()
    engine = SemanticMappingEngine(cfg, device="cpu")
    grid = torch.from_numpy(
        np.random.default_rng(5).random(engine.init_grid().shape).astype(np.float32)
    )
    path = engine.save_grid(str(tmp_path / "grid"), grid)
    assert path.endswith(".npz")
    torch.testing.assert_close(engine.load_grid(str(tmp_path / "grid")), grid, rtol=0, atol=0)
    np.testing.assert_array_equal(engine.to_hwc(grid), JaxEngine.to_hwc(grid.numpy()))
    # a JAX-package checkpoint loads into the port
    j_path = JaxEngine(cfg).save_grid(str(tmp_path / "jax_grid"), grid.numpy())
    torch.testing.assert_close(engine.load_grid(j_path), grid, rtol=0, atol=0)
    other = small_cfg()
    other.MAPPING.RESOLUTION = 0.2
    with pytest.raises(ValueError):
        SemanticMappingEngine(other, device="cpu").load_grid(path)



def test_replay_of_saved_frames_matches_jax(tmp_path):
    """``.npz`` frames cross between the packages; ``run_frames`` agrees."""
    cfg = small_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    rng = np.random.default_rng(13)
    records = []
    for i in range(N_FRAMES):
        pts, img, position, quaternion = make_frame(rng, cfg, n=2000)
        records.append(io.FrameRecord(pts, "world", img, position, quaternion, stamp=float(i)))
    io.save_frames(records, str(tmp_path / "seq.npz"))
    j_frames = j_io.load_frames(str(tmp_path / "seq.npz"))
    j_io.save_frames(j_frames, str(tmp_path / "seq_jax.npz"))
    frames = io.load_frames(str(tmp_path / "seq_jax.npz"))
    assert [f.stamp for f in frames] == [0.0, 1.0, 2.0]
    for a, b in zip(frames, records):
        np.testing.assert_array_equal(a.pcd, b.pcd)
        np.testing.assert_array_equal(a.semantic_image, b.semantic_image)
        assert (a.pcd_frame_id, a.camera) == (b.pcd_frame_id, b.camera)
    ref = JaxReplay(cfg).run_frames(j_frames, prefetch=False)
    grid = MappingReplay(cfg, device="cpu").run_frames(frames)
    _assert_grids_match(grid, ref)
