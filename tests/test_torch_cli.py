"""Port parity: the command line against the JAX package's.

``python -m vision_semantic_segmentation_tpu_torch`` (``main(argv)``,
``--device cpu``) and the JAX package's CLI run on the same recordings,
configuration and weights (a narrow DeepLabV3+, ResNet-18 OS8 with 32-wide
ASPP and decoder, f32; the flax variables saved as ``.npz``, which the port
loads through ``models/convert.py``).  Raw frames are 1440x1920 and scaled
32x before the network; clouds are world-frame, over a 200x200 grid.  On
the CPU every kernel wrapper runs its plain version.

Tolerances: grids atol 1e-4, as ``tests/test_torch_online.py`` (the nodes'
image paths and the fold's sum order differ); the planar two-node grid
equal but for at most 1e-4 of the cells, each off by one count, as in
``tests/test_torch_planar.py`` (the JAX node builds the pose's matrix in
f32, the port in f64); maps read back from disk through one reader (cv2),
equal on all but 1e-3 of cells (the JAX package renders through its
reference smooth on the CPU, the port through K1's plain version);
exported frames and scores exactly.  Every fused path runs its network in
the fused pipeline's bf16 in both packages whatever ``MODEL.COMPUTE_DTYPE``
says; the parity checks patch both packages' pipelines to f32.
"""
import functools
import glob
import inspect

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch
from scipy.spatial.transform import Rotation

import vision_semantic_segmentation_tpu.runtime.node as j_node_mod
import vision_semantic_segmentation_tpu.runtime.pipeline as j_pipeline_mod
import vision_semantic_segmentation_tpu_torch.runtime.node as node_mod
import vision_semantic_segmentation_tpu_torch.runtime.pipeline as pipeline_mod
from vision_semantic_segmentation_tpu.__main__ import main as j_main
from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.evaluation.map_eval import MapEvaluator as JaxEvaluator
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.models.convert import save_npz
from vision_semantic_segmentation_tpu.runtime.hickle_io import dump_hickle
from vision_semantic_segmentation_tpu.runtime.io import FrameRecord, save_frames
from vision_semantic_segmentation_tpu.runtime.node import MappingNode as JaxMappingNode
from vision_semantic_segmentation_tpu.runtime.replay import MappingReplay as JaxReplay
from vision_semantic_segmentation_tpu_torch.__main__ import FusedRun, main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.runtime import io, rosbag

from test_torch_models import _randomize_bn
from test_torch_online import CAMERAS, N_FRAMES, _cfg, _frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _cloud_msg(stamp, frame_id, pts):
    return rosbag.PointCloud2Msg(
        rosbag.Header(0, stamp, frame_id), 1, pts.shape[1],
        [rosbag.PointField(f, 4 * k, 7, 1) for k, f in enumerate(("x", "y", "z", "intensity"))],
        16, np.ascontiguousarray(pts.T).tobytes())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Weights, YAMLs per package (outputs apart; ``<name>`` for rectified
    frames, ``<name>_raw`` with ``VISION_SEM_SEG.UNDISTORT`` on, which the
    fused path handles on the points and the two-node path would undistort
    each frame for, ``<name>_planar`` in the planar ``DEPTH_METHOD`` over an
    ego-local 40x40 m grid), and the recordings:
    ``seq.npz`` (cameras alternating), ``one_camera.npz`` and its ``.bag``
    (camera1, 12 Hz), ``tf.bag`` whose ``/tf`` gives camera1 other
    extrinsics than the built-in ones, ``planar.npz`` (cameras alternating,
    the vehicle moving and turning near the origin) and ``slow.bag`` (the
    ``seq.npz`` frames, 1 s apart)."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(41)
    jcfg = _cfg(j_cfg_defaults, root / "out" / "jax")
    jnet = jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    variables = jax.jit(j_build_model(jnet)[0].init)(jax.random.PRNGKey(2),
                                                     jnp.zeros((1, 45, 60, 3)))
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    weights = str(root / "weights.npz")
    save_npz(variables, weights)
    yamls = {}
    for name, make in (("jax", j_cfg_defaults), ("port", get_cfg_defaults)):
        cfg = _cfg(make, root / "out" / name)
        cfg.TEST_END_TIME = 1e12
        net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
        net.MODEL.WEIGHT = weights
        net.MODEL.COMPUTE_DTYPE = "float32"
        for key, undistort in ((name, False), (f"{name}_raw", True)):
            cfg.VISION_SEM_SEG.UNDISTORT = undistort
            yamls[key] = str(root / f"{key}.yaml")
            with open(yamls[key], "w") as f:
                f.write(cfg.dump())
        cfg.MAPPING.DEPTH_METHOD = "planar"
        cfg.MAPPING.BOUNDARY = [[0, 40], [-20, 20]]
        cfg.MAPPING.RESOLUTION = 0.2
        yamls[f"{name}_planar"] = str(root / f"{name}_planar.yaml")
        with open(yamls[f"{name}_planar"], "w") as f:
            f.write(cfg.dump())

    frames = _frames(rng)

    def records(cameras, dt):
        return [FrameRecord(pcd=frames["pcd"][i], pcd_frame_id="world",
                            semantic_image=frames["image"][i], position=frames["position"][i],
                            quaternion=frames["quaternion"][i], camera=cameras[i % len(cameras)],
                            stamp=1.0 + i * dt) for i in range(N_FRAMES)]

    seq = records(CAMERAS, 1.0)
    save_frames(seq, str(root / "seq.npz"))
    save_frames([FrameRecord(**{**f.__dict__, "position": np.array([1.0 * i, 0.5 * i, 0.0]),
                                "quaternion": Rotation.from_euler("z", 0.2 * i).as_quat()})
                 for i, f in enumerate(seq)], str(root / "planar.npz"))
    one = records(("camera1",), 1 / 12)
    save_frames(one, str(root / "one_camera.npz"))
    msgs = []
    for f in one:
        msgs.append(("/reduced_map", _cloud_msg(f.stamp, "world", f.pcd), f.stamp))
        msgs.append(("/current_pose", rosbag.PoseStampedMsg(
            rosbag.Header(0, f.stamp, "world"), f.position.astype(np.float64),
            f.quaternion.astype(np.float64)), f.stamp))
        msgs.append(("/camera1/image_raw", rosbag.ImageMsg(
            rosbag.Header(0, f.stamp, "camera1"), 1440, 1920, "rgb8", f.semantic_image), f.stamp))
    rosbag.write_bag(str(root / "one_camera.bag"), msgs)
    slow = []
    for f in seq:  # images 10 ms after their clouds: see tests/test_torch_async.py
        slow.append(("/reduced_map", _cloud_msg(f.stamp, "world", f.pcd), f.stamp))
        slow.append(("/current_pose", rosbag.PoseStampedMsg(
            rosbag.Header(0, f.stamp, "world"), f.position.astype(np.float64),
            f.quaternion.astype(np.float64)), f.stamp))
        slow.append((f"/{f.camera}/image_raw", rosbag.ImageMsg(
            rosbag.Header(0, f.stamp + 0.01, f.camera), 1440, 1920, "rgb8", f.semantic_image),
            f.stamp + 0.01))
    rosbag.write_bag(str(root / "slow.bag"), slow)
    # camera1 -> base_link: the built-in calibration turned 2 degrees in yaw
    tf = rosbag.TFMessageMsg([
        rosbag.TransformStampedMsg(rosbag.Header(0, 0.5, "/velodyne"), "/base_link",
                                   np.array([-2.64, 0.0, -1.98]), np.array([0, 0, 0, 1.0])),
        rosbag.TransformStampedMsg(rosbag.Header(0, 0.5, "velodyne"), "camera1",
                                   np.array([0.05, 0.3, -0.06]),
                                   np.array([-0.5, 0.49, -0.5, 0.51])),
    ])
    rosbag.write_bag(str(root / "tf.bag"), [("/tf", tf, 0.5)] + msgs)
    return dict(root=root, yamls=yamls, variables=variables, one=one)


def _out(run, name):
    return run["root"] / "out" / name


def _png(run, name, file):
    (path,) = glob.glob(str(_out(run, name) / "**" / file), recursive=True)
    return cv2.imread(path)


def _assert_maps_match(ours, ref):
    assert ours.shape == ref.shape == (200, 200, 3)
    assert (ours.sum(-1) > 0).mean() > 0.01
    mismatch = (ours != ref).any(-1).mean()
    assert mismatch <= 1e-3, f"maps differ on {mismatch:.5f} of cells"


def _fresh_outputs(run):
    import shutil

    shutil.rmtree(run["root"] / "out", ignore_errors=True)


def test_replay(run, tmp_path):
    """``replay --input-dir --save-grid``: the grid, the combined map."""
    _fresh_outputs(run)
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    # pre-segmented frames: palette stripes under a band of an unmapped colour
    colors = np.array(get_cfg_defaults().LABEL_COLORS, np.uint8)
    labels = np.broadcast_to(np.repeat(colors, 1920 // len(colors) + 1, axis=0)[:1920],
                             (1440, 1920, 3)).copy()
    labels[:100] = 17
    io.save_frames([io.FrameRecord(**{**f.__dict__, "semantic_image": labels})
                    for f in run["one"]], str(inputs / "seq.npz"))
    maps = main(["replay", "--cfg", run["yamls"]["port"], "--input-dir", str(inputs),
                 "--save-grid", str(tmp_path / "port_grid"), "--device", "cpu"])
    j_main(["replay", "--cfg", run["yamls"]["jax"], "--input-dir", str(inputs),
            "--save-grid", str(tmp_path / "jax_grid")])
    grid = np.load(tmp_path / "port_grid.npz")["grid"]
    j_grid = np.load(tmp_path / "jax_grid.npz")["grid"]
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)
    ours = _png(run, "port", "global_map_combined.png")
    np.testing.assert_array_equal(ours, maps[0])
    _assert_maps_match(ours, _png(run, "jax", "global_map_combined.png"))


def test_replay_frame_parallel(run, tmp_path):
    """``replay --frame-parallel``: the port on its devices (one ``cpu``
    here), the JAX package over its 8; grid and map against the JAX
    package's, and the port's map equal to its sequential replay's."""
    _fresh_outputs(run)
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    colors = np.array(get_cfg_defaults().LABEL_COLORS, np.uint8)
    labels = np.broadcast_to(np.roll(np.repeat(colors, 1920 // len(colors) + 1, axis=0)[:1920],
                                     301, axis=0), (1440, 1920, 3)).copy()
    io.save_frames([io.FrameRecord(**{**f.__dict__, "semantic_image": labels})
                    for f in run["one"]], str(inputs / "seq.npz"))
    maps = main(["replay", "--cfg", run["yamls"]["port"], "--input-dir", str(inputs),
                 "--frame-parallel", "--save-grid", str(tmp_path / "port_grid"),
                 "--device", "cpu"])
    j_main(["replay", "--cfg", run["yamls"]["jax"], "--input-dir", str(inputs),
            "--frame-parallel", "--save-grid", str(tmp_path / "jax_grid")])
    grid = np.load(tmp_path / "port_grid.npz")["grid"]
    assert grid.sum() > 0
    np.testing.assert_allclose(grid, np.load(tmp_path / "jax_grid.npz")["grid"], atol=1e-5,
                               rtol=0)
    ours = _png(run, "port", "global_map_combined.png")
    np.testing.assert_array_equal(ours, maps[0])
    _assert_maps_match(ours, _png(run, "jax", "global_map_combined.png"))
    _fresh_outputs(run)
    sequential = main(["replay", "--cfg", run["yamls"]["port"], "--input-dir", str(inputs),
                       "--device", "cpu"])
    np.testing.assert_array_equal(sequential[0], maps[0])


@pytest.mark.parametrize("bag", ["seq.npz", "tf.bag"])
def test_pipeline_two_node(run, bag, monkeypatch):
    _fresh_outputs(run)
    node = main(["pipeline", "--cfg", run["yamls"]["port"], "--bag", str(run["root"] / bag),
                 "--device", "cpu"])
    j_nodes = []

    class Recording(JaxMappingNode):
        def finalize(self):
            j_nodes.append(self)
            return super().finalize()

    monkeypatch.setattr(j_node_mod, "MappingNode", Recording)
    j_main(["pipeline", "--cfg", run["yamls"]["jax"], "--bag", str(run["root"] / bag)])
    assert node.fused_frames == j_nodes[0].fused_frames == N_FRAMES and node.dropped_frames == 0
    np.testing.assert_allclose(node.grid.numpy(), np.asarray(j_nodes[0].grid), atol=1e-4, rtol=0)
    ours = _png(run, "port", "global_map.png")
    np.testing.assert_array_equal(ours, node.finalized_map)
    _assert_maps_match(ours, _png(run, "jax", "global_map.png"))
    if bag == "tf.bag":
        # camera1 took the TF extrinsics, and the map moved with them
        cam = node.engine.cameras["camera1"]
        assert not np.allclose(cam.R, node.engine.__class__(
            node.cfg, device="cpu").cameras["camera1"].R)
        plain = main(["pipeline", "--cfg", run["yamls"]["port"], "--device", "cpu",
                      "--bag", str(run["root"] / "one_camera.bag")])
        assert not np.allclose(plain.grid.numpy(), node.grid.numpy())


def test_pipeline_two_node_planar(run, monkeypatch):
    """The two-node dataflow over ``.npz`` with a planar ``DEPTH_METHOD``: no
    cloud topic, the semantic images warped onto the ground plane."""
    _fresh_outputs(run)
    bag = str(run["root"] / "planar.npz")
    node = main(["pipeline", "--cfg", run["yamls"]["port_planar"], "--bag", bag,
                 "--device", "cpu"])
    j_nodes = []

    class Recording(JaxMappingNode):
        def finalize(self):
            j_nodes.append(self)
            return super().finalize()

    monkeypatch.setattr(j_node_mod, "MappingNode", Recording)
    j_main(["pipeline", "--cfg", run["yamls"]["jax_planar"], "--bag", bag])
    assert node.pcd_topic is None and node.depth_method == "planar"
    # the planar branch counts no fused frame, in either package
    assert node.fused_frames == j_nodes[0].fused_frames == 0 and node.dropped_frames == 0
    diff = np.abs(node.grid.numpy() - np.asarray(j_nodes[0].grid))
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-4
    assert (node.grid > 0).sum() > 500
    ours = _png(run, "port", "global_map.png")
    np.testing.assert_array_equal(ours, node.finalized_map)
    _assert_maps_match(ours, _png(run, "jax", "global_map.png"))


@pytest.mark.parametrize("fused", [False, True], ids=["two_node", "fused_node"])
def test_pipeline_decode_ahead(run, fused):
    """``pipeline --rate 2 --decode-ahead``: every frame fused, none dropped,
    and the grid of the same command without ``--decode-ahead``."""
    reports = [main(["pipeline", "--cfg", run["yamls"]["port"], "--bag",
                     str(run["root"] / "slow.bag"), "--rate", "2", "--device", "cpu",
                     *(["--fused"] if fused else []), *extra])
               for extra in (["--decode-ahead"], [])]
    for report in reports:
        assert report.fused_frames == N_FRAMES and report.dropped_total == 0
        assert report.dropped_frames == 0 and not report.errors
        assert report.published == 3 * N_FRAMES
    torch.testing.assert_close(reports[0].grid, reports[1].grid, rtol=0, atol=1e-4)
    assert (reports[0].grid != 0).sum() > 100


class _Built(Exception):
    """Raised by a recording pipeline class once it has what the test needs."""


def _record_dtype(monkeypatch, module, seen, name="FusedFramePipeline"):
    """Replace ``module.name`` by a constructor that records the compute
    dtype it was called with (its default when not given) and stops."""
    real = getattr(module, name)
    signature = inspect.signature(real)

    def recording(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        seen.append(bound.arguments["compute_dtype"])
        raise _Built

    monkeypatch.setattr(module, name, recording)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_paths_run_bf16_whatever_the_config(run, dtype, monkeypatch, tmp_path):
    """Every fused entry point builds its pipeline at the pipeline's bf16,
    whatever ``MODEL.COMPUTE_DTYPE`` says, in both packages: ``pipeline
    --fused``, and in the port ``--rate --fused`` with either feed."""
    yamls = {}
    for name in ("port", "jax"):
        text = open(run["yamls"][name]).read()
        assert "COMPUTE_DTYPE: float32" in text
        yamls[name] = str(tmp_path / f"{name}.yaml")
        with open(yamls[name], "w") as f:
            f.write(text.replace("COMPUTE_DTYPE: float32", f"COMPUTE_DTYPE: {dtype}"))
    seen, j_seen = [], []
    _record_dtype(monkeypatch, pipeline_mod, seen)
    _record_dtype(monkeypatch, node_mod, seen)
    _record_dtype(monkeypatch, j_pipeline_mod, j_seen)
    bag = str(run["root"] / "one_camera.bag")
    for extra in ([], ["--rate", "1"], ["--rate", "1", "--decode-ahead"]):
        with pytest.raises(_Built):
            main(["pipeline", "--cfg", yamls["port"], "--bag", bag, "--fused", "--device",
                  "cpu", *extra])
    with pytest.raises(_Built):
        j_main(["pipeline", "--cfg", yamls["jax"], "--bag", bag, "--fused"])
    assert seen == [torch.bfloat16] * 3 and j_seen == [jnp.bfloat16]


@pytest.mark.parametrize("bag", ["one_camera.npz", "one_camera.bag"])
def test_pipeline_fused(run, bag, monkeypatch):
    """``--fused``: windows of up to 8 frames through the fused pipeline,
    raw frames with the distortion on the points (both packages' pipelines
    set to f32 for the comparison; both CLIs run bf16 otherwise)."""
    _fresh_outputs(run)
    monkeypatch.setattr(pipeline_mod, "FusedFramePipeline", functools.partial(
        pipeline_mod.FusedFramePipeline, compute_dtype=torch.float32))
    result = main(["pipeline", "--cfg", run["yamls"]["port_raw"], "--bag",
                   str(run["root"] / bag), "--fused", "--device", "cpu"])
    monkeypatch.setattr(j_pipeline_mod, "FusedFramePipeline", functools.partial(
        j_pipeline_mod.FusedFramePipeline, compute_dtype=jnp.float32))
    j_grids, finalize = [], JaxReplay.finalize

    def recording_finalize(self, grid, name=""):
        j_grids.append(np.asarray(grid))
        return finalize(self, grid, name)

    monkeypatch.setattr(JaxReplay, "finalize", recording_finalize)
    j_main(["pipeline", "--cfg", run["yamls"]["jax_raw"], "--bag", str(run["root"] / bag),
            "--fused"])
    assert isinstance(result, FusedRun) and result.frames == N_FRAMES and result.seconds > 0
    np.testing.assert_allclose(result.grid.numpy(), j_grids[0], atol=1e-4, rtol=0)
    ours = _png(run, "port", "global_map_fused.png")
    np.testing.assert_array_equal(ours, result.color_map)
    _assert_maps_match(ours, _png(run, "jax", "global_map_fused.png"))
    assert (result.grid != 0).sum() > 100


@pytest.mark.parametrize("src", ["one_camera.bag", "dump.hkl"])
def test_export(run, src, tmp_path):
    path = str(run["root"] / src)
    if src.endswith(".hkl"):
        dump_hickle([{"pcd": f.pcd, "pcd_frame_id": f.pcd_frame_id,
                      "semantic_image": f.semantic_image,
                      "pose": {"position": f.position, "orientation": f.quaternion}}
                     for f in run["one"]], path)
    frames = main(["export", path, "--out", str(tmp_path / "port.npz")])
    j_main(["export", path, "--out", str(tmp_path / "jax.npz")])
    assert len(frames) == N_FRAMES
    for name in ("port.npz", "jax.npz"):
        back = io.load_frames(str(tmp_path / name))
        assert len(back) == N_FRAMES
        for f, g in zip(back, run["one"]):
            assert (f.camera, f.pcd_frame_id) == ("camera1", "world")
            for k in ("pcd", "semantic_image", "position", "quaternion"):
                np.testing.assert_array_equal(getattr(f, k), getattr(g, k).astype(
                    getattr(f, k).dtype))
    with np.load(tmp_path / "port.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "jax.npz", allow_pickle=True) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_eval(tmp_path, capsys):
    gt = tmp_path / "gt"
    gt.mkdir()
    road = np.zeros((80, 80, 3), np.uint8)
    road[:40] = 255
    lanes = np.zeros_like(road)
    lanes[50:54] = 255
    for name, img in (("road", road), ("lanes", lanes), ("crosswalks", np.zeros_like(road)),
                      ("mask", np.full_like(road, 255))):
        cv2.imwrite(str(gt / f"bev-5cm-{name}.jpg"), img)
    maps = tmp_path / "maps"
    maps.mkdir()
    colors = np.array(get_cfg_defaults().LABEL_COLORS, np.uint8)
    for i in range(2):
        pred = np.zeros((20, 20, 3), np.uint8)
        pred[: 8 + 2 * i] = colors[0]
        pred[13] = colors[2]
        cv2.imwrite(str(maps / f"m{i}.png"), pred)
    got = main(["eval", "--maps", str(maps), "--gt", str(gt)])
    want = JaxEvaluator(ground_truth_dir=str(gt)).full_test(dir_path=str(maps))
    np.testing.assert_equal(got, want)  # NaN IoU of an absent class included
    assert got["num_maps"] == 2
    assert "IOU road" in capsys.readouterr().out
