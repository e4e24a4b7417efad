"""Port parity: offline replay of recorded files against the JAX package.

``MappingReplay.replay_dir`` over a directory holding one ``.npz``, one
``.hkl`` and one ``.pkl`` sequence of pre-segmented frames (palette-coloured
semantic images, world-frame clouds), per file and in continuous mode
(``save_grid`` / ``resume_grid``), in the port and in the JAX package on the
CPU.  On the CPU the port's fold and render run K2's and K1's plain
versions.  Tolerances: grids atol 1e-4 (the fold sums five products in
another order); maps read back from disk through one reader, equal on all
but 1e-3 of cells (the JAX package renders through its reference smooth on
the CPU, the port through K1's plain version, as
``tests/test_torch_pipeline.py`` holds).  Parallel replay
(``MAPPING.GRID_SHARDS``, ``frame_parallel`` and both) runs the port on 8
logical ``cpu`` shards beside the JAX package's 8 virtual devices: grids
atol 1e-5 against the JAX package's; against the port's own sequential
replay the JAX tests' tolerances (sharded atol 1e-4, and bit-equal here;
frame-parallel rtol 1e-5, atol 1e-4).
"""
import pickle

import cv2
import jax
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.runtime import io as j_io
from vision_semantic_segmentation_tpu.runtime.hickle_io import dump_hickle
from vision_semantic_segmentation_tpu.runtime.replay import MappingReplay as JaxReplay
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.parallel import ShardedGrid
from vision_semantic_segmentation_tpu_torch.runtime import MappingReplay, io
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

X0 = 100 - PCD_ORIGIN_OFFSET[0]
Y0 = 800 - PCD_ORIGIN_OFFSET[1]
FILES = ("seq_a.npz", "seq_b.hkl", "seq_c.pkl")


def _cfg(make, tmp_path, sub):
    cfg = make()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]  # 200x200 cells at 0.1 m
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.OUTPUT_DIR = str(tmp_path / "out" / sub)
    return cfg


def _frames(seed, n=3):
    """Pre-segmented frames: palette stripes (shifted per seed) under a band
    of an unmapped colour, clouds snapped to cell centres over the grid, the
    vehicle behind it facing +x."""
    rng = np.random.default_rng(seed)
    colors = np.array(get_cfg_defaults().LABEL_COLORS, np.uint8)
    stripes = np.roll(np.repeat(colors, 1920 // len(colors) + 1, axis=0)[:1920], 97 * seed, axis=0)
    image = np.broadcast_to(stripes, (1440, 1920, 3)).copy()
    image[:100] = 17
    snap = lambda v, lo: lo + (np.floor((v - lo) / 0.1) + 0.5) * 0.1  # noqa: E731
    frames = []
    for i in range(n):
        pts = np.vstack([snap(rng.uniform(X0, X0 + 20, 1500), X0),
                         snap(rng.uniform(Y0, Y0 + 20, 1500), Y0),
                         rng.uniform(-1.0, 0.5, 1500), rng.uniform(0, 20, 1500)])
        frames.append(dict(pcd=pts.astype(np.float32), pcd_frame_id="world",
                           semantic_image=image, position=np.array([X0 - 6.0, Y0 + 10.0, 0.0]),
                           quaternion=np.array([0.0, 0.0, 0.0, 1.0])))
    return frames


def _write(path, frames):
    """One sequence in the format its suffix names."""
    if path.endswith(".npz"):
        j_io.save_frames([j_io.FrameRecord(**f, stamp=float(i)) for i, f in enumerate(frames)],
                         path)
        return
    dump = [{"pcd": f["pcd"], "pcd_frame_id": f["pcd_frame_id"],
             "semantic_image": f["semantic_image"],
             "pose": {"position": f["position"], "orientation": f["quaternion"]}}
            for f in frames]
    if path.endswith(".hkl"):
        dump_hickle(dump, path)
    else:
        with open(path, "wb") as fh:
            pickle.dump(dump, fh)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    root = tmp_path_factory.mktemp("replay")
    for seed, name in enumerate(FILES, start=1):
        (root / f"only_{seed}").mkdir()
        for d in ("all", f"only_{seed}"):
            (root / d).mkdir(exist_ok=True)
            _write(str(root / d / name), _frames(seed))
    jreplay = JaxReplay(_cfg(j_cfg_defaults, root, "jax"))
    replay = MappingReplay(_cfg(get_cfg_defaults, root, "port"), device="cpu")
    return dict(root=root, jreplay=jreplay, replay=replay,
                j_maps=jreplay.replay_dir(str(root / "all")),
                maps=replay.replay_dir(str(root / "all")))


def _read_png(replay, name):
    img = cv2.imread(f"{replay.output_dir}/global_map_{name}.png")
    assert img is not None, name
    return img


def _assert_maps_match(ours, ref):
    assert ours.shape == ref.shape == (200, 200, 3)
    assert (ours.sum(-1) > 0).mean() > 0.05
    mismatch = (ours != ref).any(-1).mean()
    assert mismatch <= 1e-3, f"maps differ on {mismatch:.5f} of cells"


@pytest.mark.parametrize("name", FILES)
def test_replay_dir_per_file(recordings, name):
    r = recordings
    path = str(r["root"] / "all" / name)
    grid = r["replay"].replay_file(path, return_grid=True).numpy()
    j_grid = np.asarray(r["jreplay"].replay_file(path, return_grid=True))
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)
    stem = name.split(".")[0]
    _assert_maps_match(_read_png(r["replay"], stem), _read_png(r["jreplay"], stem))
    i = FILES.index(name)
    np.testing.assert_array_equal(r["maps"][i], _read_png(r["replay"], stem))
    assert len(r["maps"]) == len(r["j_maps"]) == len(FILES)


def _continuous(replay, root, tmp_path, tag):
    """Files 1-2 with save_grid, then file 3 resumed from it: one grid."""
    first, second = str(tmp_path / f"{tag}_12.npz"), str(tmp_path / f"{tag}_123.npz")
    (root / f"{tag}_12").mkdir()
    for name in FILES[:2]:
        (root / f"{tag}_12" / name).write_bytes((root / "all" / name).read_bytes())
    replay.replay_dir(str(root / f"{tag}_12"), save_grid=first)
    maps = replay.replay_dir(str(root / "only_3"), resume_grid=first, save_grid=second)
    return maps, second


def test_continuous_resume_matches(recordings, tmp_path):
    r = recordings
    maps, saved = _continuous(r["replay"], r["root"], tmp_path, "port")
    j_maps, j_saved = _continuous(r["jreplay"], r["root"], tmp_path, "jax")
    grid = r["replay"].engine.load_grid(saved).numpy()
    j_grid = np.asarray(r["jreplay"].engine.load_grid(j_saved))
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)
    assert len(maps) == len(j_maps) == 1
    _assert_maps_match(maps[0], j_maps[0])
    # equal to one replay of all the files
    once = r["replay"].replay_dir(str(r["root"] / "all"), save_grid=str(tmp_path / "once.npz"))
    np.testing.assert_allclose(grid, r["replay"].engine.load_grid(str(tmp_path / "once.npz")),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(maps[0], once[0])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_grid_resumes_in_the_other_package(recordings, saver, tmp_path):
    r = recordings
    grid = np.random.default_rng(5).random((5, 200, 200)).astype(np.float32)
    engines = {"jax": r["jreplay"].engine, "port": r["replay"].engine}
    path = engines[saver].save_grid(str(tmp_path / "g"), grid)
    for loader in engines.values():
        np.testing.assert_array_equal(np.asarray(loader.load_grid(path)), grid)
    only = str(r["root"] / "only_1" / FILES[0])
    resumed = r["replay"].replay_file(only, init_grid=r["replay"].engine.load_grid(path),
                                      return_grid=True)
    j_resumed = r["jreplay"].replay_file(only, init_grid=r["jreplay"].engine.load_grid(path),
                                         return_grid=True)
    np.testing.assert_allclose(resumed.numpy(), np.asarray(j_resumed), atol=1e-4, rtol=0)


def test_empty_dir_prints_message(tmp_path, capsys):
    cfg = _cfg(get_cfg_defaults, tmp_path, "port")
    cfg.MAPPING.INPUT_DIR = str(tmp_path / "nonexistent")
    assert MappingReplay(cfg, device="cpu").replay_dir() == []
    assert "no sequence files" in capsys.readouterr().err


def test_windows_prefetch_and_single_frames(recordings):
    """Windows staged on the prefetch thread, stretches cut by camera and
    image shape, and single frames through ``engine.step``, all equal one
    frame-by-frame loop bit for bit; the chunks are the JAX package's."""
    frames = [io.FrameRecord(**f) for f in _frames(4, n=6)]
    frames[2].camera = "camera6"
    frames[4].semantic_image = frames[4].semantic_image[:720]
    keys = [[(f.camera, f.semantic_image.shape) for f in c]
            for c in MappingReplay._chunk_frames(frames, 2)]
    assert keys == [[(f.camera, f.semantic_image.shape) for f in c]
                    for c in JaxReplay._chunk_frames(frames, 2)]
    assert [len(c) for c in keys] == [2, 1, 1, 1, 1]
    replay = recordings["replay"]
    want = replay.engine.init_grid()
    for f in frames:
        want = replay.run_frames([f], window=1, prefetch=False, init_grid=want)
    for window, prefetch in ((2, True), (8, True), (8, False)):
        got = replay.run_frames(frames, window=window, prefetch=prefetch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(want.abs().sum()) > 0


def test_sequence_runner_is_cached_and_equals_steps(recordings):
    engine = recordings["replay"].engine
    frames = recordings["replay"]._stage([io.FrameRecord(**f) for f in _frames(6)])
    run = engine.build_sequence_runner("camera1", "world")
    assert engine.build_sequence_runner("camera1", "map") is run
    assert engine.build_sequence_runner("camera1", "velodyne") is not run
    got = run(engine.init_grid(), frames.wait())
    want = engine.init_grid()
    for i in range(3):
        want, _, _ = engine.step(want, *(frames[k][i] for k in (
            "pcd", "valid", "image", "position", "quaternion")))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _sharded_cfg(make, root, sub, grid_shards):
    cfg = _cfg(make, root, sub)
    cfg.MAPPING.GRID_SHARDS = grid_shards
    return cfg


def _port_parallel(root, sub, grid_shards=1, frame_parallel=False):
    """The port's replay over 8 logical cpu shards, as the JAX package's
    over its 8 virtual devices."""
    return MappingReplay(_sharded_cfg(get_cfg_defaults, root, sub, grid_shards), device="cpu",
                         devices=["cpu"] * 8, frame_parallel=frame_parallel)


def _jax_parallel(root, sub, grid_shards=1, frame_parallel=False):
    return JaxReplay(_sharded_cfg(j_cfg_defaults, root, sub, grid_shards),
                     frame_parallel=frame_parallel)


def _records(seed, n):
    return [io.FrameRecord(**f, stamp=float(i)) for i, f in enumerate(_frames(seed, n=n))]


def test_grid_shards_replay_matches_jax(recordings, tmp_path):
    """``MAPPING.GRID_SHARDS`` 4: sequential replay with the grid in 4 row
    bands; the JAX package's, and the port's unsharded replay bit for bit."""
    frames = _records(7, 5)
    got = _port_parallel(tmp_path, "port", 4).run_frames(frames, window=2)
    assert isinstance(got, ShardedGrid)
    assert [tuple(b.shape) for b in got.bands] == [(5, 50, 200)] * 4
    j_got = _jax_parallel(tmp_path, "jax", 4).run_frames(frames, window=2)
    assert j_got.sharding.spec == jax.sharding.PartitionSpec(None, "grid")
    grid = got.gather()
    np.testing.assert_allclose(grid.numpy(), np.asarray(j_got), atol=1e-5, rtol=0)
    want = recordings["replay"].run_frames(frames, window=2)
    assert float(want.sum()) > 0
    np.testing.assert_allclose(grid.numpy(), want.numpy(), atol=1e-4, rtol=0)
    torch.testing.assert_close(grid, want, rtol=0, atol=0)  # bit for bit


def test_frame_parallel_with_grid_shards_matches_jax(recordings, tmp_path):
    """``frame_parallel`` with ``GRID_SHARDS`` 2: frames over 4 'data'
    shards, rows over 2 'grid' shards, one psum per band."""
    frames = _records(8, 8)
    got = _port_parallel(tmp_path, "port", 2, True).run_frames_parallel(frames)
    assert isinstance(got, ShardedGrid) and len(got.bands) == 2
    j_got = _jax_parallel(tmp_path, "jax", 2, True).run_frames_parallel(frames)
    np.testing.assert_allclose(got.gather().numpy(), np.asarray(j_got), atol=1e-5, rtol=0)
    want = recordings["replay"].run_frames(frames).numpy()
    assert want.sum() > 0
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("grid_shards", [1, 2])
def test_frame_parallel_resume_adds_once(recordings, tmp_path, grid_shards):
    """A resumed grid is added once, outside the psum (inside it would
    count once a shard), as in the JAX package."""
    frames = _records(9, 8)
    replay = _port_parallel(tmp_path, "port", grid_shards, True)
    base = recordings["replay"].run_frames(frames[:4])
    fresh = replay.run_frames_parallel(frames[4:])
    got = replay.run_frames_parallel(frames[4:], init_grid=base)
    if grid_shards > 1:
        fresh, got = fresh.gather(), got.gather()
    np.testing.assert_allclose(got.numpy(), (base + fresh).numpy(), atol=1e-5, rtol=0)
    j_replay = _jax_parallel(tmp_path, "jax", grid_shards, True)
    j_got = j_replay.run_frames_parallel(frames[4:], init_grid=np.asarray(base))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["shards_over_devices", "devices_do_not_split",
                                  "heterogeneous", "no_frames"])
def test_parallel_replay_refusals(case, tmp_path):
    """Where the JAX package asserts, the port raises ``ValueError`` with the
    same words; it never quietly runs unsharded."""
    frames = _records(10, 2)
    grid_shards = {"shards_over_devices": 16, "devices_do_not_split": 3}.get(case, 1)
    if case == "heterogeneous":
        frames[1].camera = "camera6"
    if case == "no_frames":
        frames = []
    port = _port_parallel(tmp_path, "port", grid_shards, True)
    jax_replay = _jax_parallel(tmp_path, "jax", grid_shards, True)
    run = "run_frames" if case == "shards_over_devices" else "run_frames_parallel"
    with pytest.raises(AssertionError) as j_err:
        getattr(jax_replay, run)(frames)
    with pytest.raises(ValueError) as err:
        getattr(port, run)(frames)
    assert str(err.value) == str(j_err.value)


def test_grid_shards_continuous_replay_dir(recordings, tmp_path):
    """``replay_dir`` threads a sharded grid through the files, saves it and
    renders it (``save_grid``, ``resume_grid``, ``finalize`` gather it
    once): equal to the JAX package's and to the unsharded replay."""
    r = recordings
    maps, saved = _continuous(_port_parallel(r["root"], "port_sharded", 4), r["root"],
                              tmp_path, "port_sharded")
    j_maps, j_saved = _continuous(_jax_parallel(r["root"], "jax_sharded", 4), r["root"],
                                  tmp_path, "jax_sharded")
    grid = r["replay"].engine.load_grid(saved).numpy()
    np.testing.assert_allclose(grid, r["jreplay"].engine.load_grid(j_saved), atol=1e-5, rtol=0)
    _assert_maps_match(maps[0], j_maps[0])
    once = r["replay"].replay_dir(str(r["root"] / "all"), save_grid=str(tmp_path / "once.npz"))
    np.testing.assert_allclose(grid, r["replay"].engine.load_grid(str(tmp_path / "once.npz")),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(maps[0], once[0])


def test_frame_parallel_replay_file_and_fallback(recordings, tmp_path):
    """``frame_parallel`` replays a homogeneous file data-parallel; a file
    with two image shapes takes the sequential path, as in the JAX package."""
    frames = _records(11, 4)
    mixed = [io.FrameRecord(**{**f.__dict__}) for f in frames]
    mixed[2].semantic_image = mixed[2].semantic_image[:720]
    for name, part in (("even.npz", frames), ("mixed.npz", mixed)):
        j_io.save_frames(part, str(tmp_path / name))
    port = _port_parallel(tmp_path, "port", 1, True)
    j_port = _jax_parallel(tmp_path, "jax", 1, True)
    calls = []
    run_parallel = port.run_frames_parallel
    port.run_frames_parallel = lambda *a, **k: calls.append(1) or run_parallel(*a, **k)
    for name in ("even.npz", "mixed.npz"):
        got = port.replay_file(str(tmp_path / name), return_grid=True)
        j_got = j_port.replay_file(str(tmp_path / name), return_grid=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_got), atol=1e-5, rtol=0)
    assert calls == [1]  # the mixed file fell back to run_frames
    torch.testing.assert_close(got, recordings["replay"].run_frames(mixed), rtol=0, atol=0)
