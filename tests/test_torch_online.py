"""Port parity: the online serving path against the JAX package.

The same numpy inputs and the same weights (flax variables converted with
``flax_to_state_dict``) go through the JAX package and the port on the CPU,
in f32, with a narrow DeepLabV3+ (ResNet-18, OS8, 32-wide ASPP and decoder).
Raw frames are 1440x1920 (the calibrations' size, which undistortion
needs), downscaled 32x before the network; the segmentation tests feed
64x96 frames directly.  On the CPU every kernel wrapper runs its plain
version: the forward's ASPP takes K4's plain path, the updates K2's,
finalize K1's.

Tolerances, each with its reason:
  * labels equal on >= 99.9 % of pixels and confidence to 1e-4: the two
    networks sum in other orders (logits agree to ~1e-5), which may flip a
    near-tie argmax;
  * remap and undistort: uint8 equal except +-1 on <= 1e-3 of pixels (a
    bilinear value near .5 rounds either way);
  * grids atol 1e-5 for the engine and the confidence-weighted pipeline
    (the fold sums five products in another order; the confidences carry
    the networks' ~1e-7 difference), 1e-4 where the nodes' image paths
    (undistortion, colourise, palette match) feed them; maps equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.geometry.camera import get_camera as j_get_camera
from vision_semantic_segmentation_tpu.inference.predictor import (
    SemanticSegmentation as JaxSegmentation,
    preprocess_frame as j_preprocess_frame,
)
from vision_semantic_segmentation_tpu.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu.mapping.engine import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.models.convert import save_npz
from vision_semantic_segmentation_tpu.ops.warp import remap_bilinear as j_remap
from vision_semantic_segmentation_tpu.runtime.bus import TopicBus as JaxBus
from vision_semantic_segmentation_tpu.runtime.bus import nearest_stamp_index as j_nearest
from vision_semantic_segmentation_tpu.runtime.node import (
    FusedOnlineNode as JaxFusedNode,
    MappingNode as JaxMappingNode,
    SegmentationNode as JaxSegNode,
)
from vision_semantic_segmentation_tpu.runtime.pipeline import FusedFramePipeline as JaxPipeline
from vision_semantic_segmentation_tpu.train.datasets.visualization import (
    palette_from_cfg as j_palette_from_cfg,
)
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.geometry.camera import get_camera
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation, preprocess_frame
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine
from vision_semantic_segmentation_tpu_torch.models import Dummy, flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.ops.colormap import palette_from_cfg
from vision_semantic_segmentation_tpu_torch.ops.warp import remap_bilinear, undistort
from vision_semantic_segmentation_tpu_torch.runtime import (
    FusedFramePipeline,
    FusedOnlineNode,
    MappingNode,
    SegmentationNode,
    TopicBus,
    nearest_stamp_index,
)

from test_torch_models import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

IMAGE_HW = (1440, 1920)
SCALE = 1.0 / 32
N_FRAMES = 4
CAMERAS = ("camera1", "camera6")


def _cfg(make, out_dir):
    cfg = make()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]  # 200x200 cells at 0.1 m
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = SCALE
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.ASPP.OUT_CHANNELS = 32
    net.MODEL.ASPP.ATROUS_CHANNELS = [32, 32, 32, 32]
    net.MODEL.DECODER.REFINE_CHANNELS = [32, 32]
    return cfg


def _frames(rng):
    """Raw frames (coarse 16x16-pixel blocks) and world-frame clouds over the
    grid, the vehicle behind it facing +x."""
    x0 = 100 - PCD_ORIGIN_OFFSET[0]
    y0 = 800 - PCD_ORIGIN_OFFSET[1]
    n = 2048
    xy = rng.uniform([[x0], [y0]], [[x0 + 20], [y0 + 20]], (N_FRAMES, 2, n))
    zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (N_FRAMES, 2, n))
    coarse = rng.integers(0, 256, (N_FRAMES, 90, 120, 3), dtype=np.uint8)
    return {
        "image": coarse.repeat(16, axis=1).repeat(16, axis=2),
        "pcd": np.concatenate([xy, zi], axis=1).astype(np.float32),
        "position": np.tile(np.float32([x0 - 6.0, y0 + 10.0, 0.0]), (N_FRAMES, 1)),
        "quaternion": np.tile(np.float32([0, 0, 0, 1]), (N_FRAMES, 1)),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Configs, frames and weights whose labels take several map channels."""
    rng = np.random.default_rng(33)
    out_dir = tmp_path_factory.mktemp("online")
    jcfg = _cfg(j_cfg_defaults, out_dir)
    cfg = _cfg(get_cfg_defaults, out_dir)
    jmodel = j_build_model(jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK)[0]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 45, 60, 3)))
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    frames = _frames(rng)
    # A random network gives every pixel the class with the largest mean
    # logit: centre the logits on frame 0 and hold the unmapped classes back
    seg = jax.jit(JaxPipeline(jcfg, variables, compute_dtype=jnp.float32)
                  ._build_segmentation("camera1", IMAGE_HW))
    logits = np.asarray(seg(variables, jnp.asarray(frames["image"][0])))[0]
    head = variables["params"]["decoder"]["refine_layers_2"]["conv"]
    unmapped = ~np.isin(np.arange(19), jcfg.LABELS)
    head["bias"] = (head["bias"] - logits.mean((0, 1))
                    - unmapped * 0.5 * logits.std((0, 1))).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, frames=frames, out_dir=out_dir)


def _near_equal_u8(ours: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.5f} of pixels differ by 1"


# -- warp -------------------------------------------------------------------
@pytest.mark.parametrize("camera", CAMERAS)
def test_undistort_maps_match(camera):
    ours = get_camera(camera).undistort_maps()
    ref = j_get_camera(camera).undistort_maps()
    assert ours.shape == ref.shape == (2, 1440, 1920) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_bilinear_matches(dtype):
    rng = np.random.default_rng(5)
    image = (rng.random((48, 64, 3)) * 255).astype(dtype)
    # coordinates inside, on the border and outside the source
    map_xy = np.stack([rng.uniform(-3, 67, (40, 50)), rng.uniform(-3, 51, (40, 50))])
    map_xy = map_xy.astype(np.float32)
    ours = remap_bilinear(torch.from_numpy(image), torch.from_numpy(map_xy)).numpy()
    ref = np.asarray(j_remap(jnp.asarray(image), jnp.asarray(map_xy)))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape == (40, 50, 3)
    if dtype == np.uint8:
        _near_equal_u8(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_undistort_full_frame(setup):
    image = setup["frames"]["image"][0]
    maps = j_get_camera("camera1").undistort_maps()
    ours = undistort(torch.from_numpy(image), torch.from_numpy(maps)).numpy()
    ref = np.asarray(j_remap(jnp.asarray(image), jnp.asarray(maps)))
    _near_equal_u8(ours, ref)
    assert (ours == 0).all(-1).mean() < 0.2  # most of the frame maps inside the source


def test_preprocess_frame_matches(setup):
    image = setup["frames"]["image"][0]
    maps = j_get_camera("camera6").undistort_maps()
    ours = preprocess_frame(image, undistort_map=maps, image_scale=0.25, device="cpu")
    ref = np.asarray(j_preprocess_frame(image, undistort_map=maps, image_scale=0.25))
    assert ours.device.type == "cpu" and ours.shape == (360, 480, 3)
    _near_equal_u8(ours.numpy(), ref)


def test_preprocess_frame_defaults_to_cuda(monkeypatch):
    """A host frame goes to the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_frame(np.zeros((8, 8, 3), np.uint8))


# -- predictor ----------------------------------------------------------------
@pytest.fixture(scope="module")
def predictors(setup):
    net, jnet = setup["cfg"].VISION_SEM_SEG.SEM_SEG_NETWORK, setup["jcfg"].VISION_SEM_SEG.SEM_SEG_NETWORK
    ours = SemanticSegmentation(net, variables=setup["variables"], compute_dtype="float32",
                                device="cpu")
    ref = JaxSegmentation(jnet, variables=setup["variables"], compute_dtype="float32")
    image = setup["frames"]["image"][1][::15, ::20][:64, :96]  # a 64x96 frame
    return ours, ref, np.ascontiguousarray(image)


@pytest.mark.parametrize("upsample_pred", [False, True])
def test_segmentation_labels(predictors, upsample_pred):
    ours, ref, image = predictors
    got = ours.segmentation(image, upsample_pred=upsample_pred)
    want = ref.segmentation(image, upsample_pred=upsample_pred)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.shape == ((64, 96) if upsample_pred else (12, 20))  # unpadded refine convs
    assert (got == want).mean() >= 0.999
    assert len(np.unique(got)) > 1


def test_segmentation_with_confidence(predictors):
    ours, ref, image = predictors
    labels, conf = ours.segmentation_with_confidence(image, upsample_pred=True)
    j_labels, j_conf = ref.segmentation_with_confidence(image, upsample_pred=True)
    assert (labels == j_labels).mean() >= 0.999
    np.testing.assert_allclose(conf, j_conf, atol=1e-4, rtol=0)
    assert conf.min() > 1.0 / 19 and conf.max() <= 1.0
    logits = ours.logits(image, upsample_pred=True)  # the JAX package's NHWC layout
    assert logits.shape == (1, 64, 96, 19)
    np.testing.assert_array_equal(logits[0].argmax(-1).numpy(), labels)


def test_weights_from_files(setup, tmp_path):
    net = setup["cfg"].VISION_SEM_SEG.SEM_SEG_NETWORK.clone()
    want = flax_to_state_dict(setup["variables"])
    save_npz(setup["variables"], str(tmp_path / "w.npz"))
    torch.save({"model": want}, tmp_path / "w.pth")
    for name in ("w.npz", "w.pth"):
        net.MODEL.WEIGHT = str(tmp_path / name)
        got = SemanticSegmentation(net, compute_dtype="float32", device="cpu").model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k].to(got[k].dtype), rtol=0, atol=0)
    net.MODEL.WEIGHT = ""
    with pytest.raises(ValueError, match="WEIGHT"):
        SemanticSegmentation(net, device="cpu")


def test_palette_from_cfg(tmp_path):
    net = get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
    jnet = j_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
    (tmp_path / "labels.json").write_text('{"labels": [{"color": [1, 2, 3]}, {"color": [4, 5, 6]}]}')
    for change in ({}, {"TRAIN_DATASET": "BDD"}, {"DATASET_CONFIG": str(tmp_path / "labels.json")}):
        for k, v in change.items():
            net[k], jnet[k] = v, v
        np.testing.assert_array_equal(palette_from_cfg(net), j_palette_from_cfg(jnet))


# -- engine and pipeline: confidence weighting --------------------------------
@pytest.mark.parametrize("semantics", ["reference", "accumulate"])
def test_engine_confidence_weighting(setup, semantics):
    rng = np.random.default_rng(8)
    jeng = JaxEngine(setup["jcfg"], duplicate_semantics=semantics)
    eng = SemanticMappingEngine(setup["cfg"], duplicate_semantics=semantics, device="cpu")
    n = 4096
    # points crowd a 30x30 patch, so (cell, class) hits repeat
    cell = (rng.integers(50, 80, n) * 200 + rng.integers(50, 80, n)).astype(np.int32)
    cls = rng.integers(0, 5, n).astype(np.int32)
    upd = rng.random(n) < 0.9
    intensity = rng.uniform(0, 20, n).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, n).astype(np.float32)
    grid0 = rng.standard_normal((5, 200, 200)).astype(np.float32)

    j_update = jax.jit(jeng._build_update())
    want = np.asarray(j_update(jnp.asarray(grid0), *map(jnp.asarray, (cell, cls, intensity, upd)),
                               weights=jnp.asarray(weights)))
    update = eng._build_update()
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = update(t(grid0.copy()), t(cell), t(cls), t(intensity), t(upd), weights=t(weights))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(want - grid0).max() > 0.1

    # every weight at 1: exactly the unweighted update
    ones = update(t(grid0.copy()), t(cell), t(cls), t(intensity), t(upd),
                  weights=torch.ones(n))
    plain = update(t(grid0.copy()), t(cell), t(cls), t(intensity), t(upd))
    torch.testing.assert_close(ones, plain, rtol=0, atol=0)


def _pipelines(setup, **kw):
    jpipe = JaxPipeline(setup["jcfg"], setup["variables"], compute_dtype=jnp.float32, **kw)
    pipe = FusedFramePipeline(setup["cfg"], state_dict=flax_to_state_dict(setup["variables"]),
                              compute_dtype=torch.float32, device="cpu", **kw)
    return jpipe, pipe


def _run_both(setup, jpipe, pipe, frames=range(2)):
    f = setup["frames"]
    valid = np.ones(f["pcd"].shape[-1], bool)
    j_grid, grid = jpipe.init_grid(), pipe.init_grid()
    for i in frames:
        cam = CAMERAS[i % 2]
        args = (f["image"][i], f["pcd"][i], valid, f["position"][i], f["quaternion"][i])
        j_grid, _ = jpipe.step(j_grid, *args, camera=cam)
        grid, _ = pipe.step(grid, *map(torch.from_numpy, args), camera=cam)
    return np.asarray(j_grid), grid.numpy()


def test_pipeline_confidence_weighting(setup):
    jpipe, pipe = _pipelines(setup, distortion="points", confidence_weighting=True)
    j_grid, grid = _run_both(setup, jpipe, pipe)
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(grid, j_grid, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(grid != 0, j_grid != 0)
    # fractional evidence: some hit carries a confidence below 1
    _, unweighted = _run_both(setup, *_pipelines(setup, distortion="points"))
    assert not np.allclose(grid, unweighted)


def test_pipeline_image_distortion_upsampled(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jcfg.VISION_SEM_SEG.UPSAMPLE_PRED = cfg.VISION_SEM_SEG.UPSAMPLE_PRED = True
    try:
        jpipe, pipe = _pipelines(setup, distortion="image")
    finally:
        jcfg.VISION_SEM_SEG.UPSAMPLE_PRED = cfg.VISION_SEM_SEG.UPSAMPLE_PRED = False
    assert pipe.upsample_pred and set(pipe._undistort_maps) == set(CAMERAS)
    j_grid, grid = _run_both(setup, jpipe, pipe)
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)


# -- the nodes over the bus ------------------------------------------------------
def _feed(bus, frames):
    """Frame 0's image arrives before any cloud (a drop); then each frame's
    cloud, pose and image, cameras alternating; the last pose reaches
    TEST_END_TIME and finalizes the map."""
    bus.publish("/camera1/image_raw", frames["image"][0], stamp=0.5, frame_id="camera1")
    for i in range(N_FRAMES):
        stamp = 1.0 + i
        cam = CAMERAS[i % 2]
        bus.publish("/reduced_map", frames["pcd"][i], stamp=stamp, frame_id="world")
        bus.publish("/current_pose", (frames["position"][i], frames["quaternion"][i]), stamp=stamp)
        bus.publish(f"/{cam}/image_raw", frames["image"][i], stamp=stamp, frame_id=cam)


def _node_cfgs(setup, tmp_path):
    jcfg, cfg = setup["jcfg"].clone(), setup["cfg"].clone()
    for c, sub in ((jcfg, "jax"), (cfg, "port")):
        c.TEST_END_TIME = float(N_FRAMES)
        c.OUTPUT_DIR = str(tmp_path / sub)
    return jcfg, cfg


def _assert_nodes_match(j_node, node):
    assert node.fused_frames == j_node.fused_frames == N_FRAMES
    assert node.dropped_frames == j_node.dropped_frames == 1
    j_grid = np.asarray(j_node.grid)
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(node.grid.numpy(), j_grid, atol=1e-4, rtol=0)
    assert node.finalized_map is not None and node.finalized_map.shape == (200, 200, 3)
    np.testing.assert_array_equal(node.finalized_map, j_node.finalized_map)


def test_two_node_topology(setup, tmp_path):
    jcfg, cfg = _node_cfgs(setup, tmp_path)
    net, jnet = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    assert cfg.VISION_SEM_SEG.UNDISTORT  # the 'image' undistortion path

    jbus = JaxBus()
    JaxSegNode(jcfg, jbus, predictor=JaxSegmentation(jnet, variables=setup["variables"],
                                                     compute_dtype="float32"))
    j_node = JaxMappingNode(jcfg, jbus)
    bus = TopicBus()
    predictor = SemanticSegmentation(net, variables=setup["variables"],
                                     compute_dtype="float32", device="cpu")
    SegmentationNode(cfg, bus, predictor=predictor)
    node = MappingNode(cfg, bus, device="cpu")
    _feed(jbus, setup["frames"])
    _feed(bus, setup["frames"])

    _assert_nodes_match(j_node, node)
    for topic in ("/camera1/semantic", "/camera6/semantic", "/semantic_point_cloud",
                  "/semantic_local_map"):
        assert bus.published_counts[topic] == jbus.published_counts[topic] > 0
    assert (tmp_path / "port" / "version_0" / "global_map.png").exists()


def test_fused_online_node(setup, tmp_path):
    jcfg, cfg = _node_cfgs(setup, tmp_path)
    jpipe, pipe = _pipelines(setup, distortion="points")
    j_node = JaxFusedNode(jcfg, JaxBus(), pipeline=jpipe)
    bus = TopicBus()
    node = FusedOnlineNode(cfg, bus, pipeline=pipe)
    _feed(j_node.bus, setup["frames"])
    _feed(bus, setup["frames"])
    _assert_nodes_match(j_node, node)
    assert bus.published_counts["/semantic_point_cloud"] == 0


def test_nearest_stamp_index_matches():
    rng = np.random.default_rng(2)
    for _ in range(50):
        stamps = sorted(rng.uniform(0, 10, rng.integers(1, 8)).round(1).tolist())
        target = round(float(rng.uniform(-1, 11)), 1)
        assert nearest_stamp_index(stamps, target) == j_nearest(stamps, target)


def _qpack(cfg, bus):
    """int8 serving is ported (tests/test_torch_quant_serving.py); a qpack
    for a network without a ResNet backbone is refused."""
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.TYPE = "Dummy"
    net.MODEL.QPACK = "int8.npz"
    SemanticSegmentation(net, state_dict=Dummy(net.DATASET.NUM_CLASSES).state_dict(),
                         device="cpu")


def _spatial(cfg, bus):
    """Spatially sharded serving is ported (tests/test_torch_spatial_infer.py);
    more shards than the one CPU device are refused, as in the JAX package."""
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.SPATIAL_SHARDS = 4
    SemanticSegmentation(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu")


@pytest.mark.parametrize("make,error,match", [(_qpack, ValueError, "DeepLabV3"),
                                              (_spatial, ValueError, "devices")],
                         ids=["qpack", "spatial_shards"])
def test_unported_options_refused(make, error, match, tmp_path):
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(error, match=match):
        make(cfg, TopicBus())
