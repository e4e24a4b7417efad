"""Port parity: the slice as a whole, frame window -> grid -> finalized map -> scores.

The same weights (flax variables converted with ``flax_to_state_dict``) and
the same raw 1440x1920 frames go through the JAX package's
``FusedFramePipeline`` sequence runner + ``MappingReplay.finalize`` and the
port's ``FusedFramePipeline.run_window`` + ``MappingReplay.finalize`` on the
CPU, in f32, with a small DeepLabV3+ (ResNet-18, OS8, narrow ASPP/decoder)
on a 1/16-scale input and a 200x200 grid.  On the CPU the port's three
kernel wrappers run their plain versions.

Tolerances: grid atol 1e-4 (the evidence is summed in another order), with
the same set of nonzero cells; rendered maps equal on >= 99.9 % of cells
(the JAX unfused render sums nine shifted planes, K1 sums separably, so a
near-tie argmax may flip); the evaluator's scores equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.evaluation.map_eval import MapEvaluator as JaxEvaluator
from vision_semantic_segmentation_tpu.mapping import PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime.pipeline import FusedFramePipeline as JaxPipeline
from vision_semantic_segmentation_tpu.runtime.replay import MappingReplay as JaxReplay
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.evaluation.map_eval import MapEvaluator
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline, MappingReplay

from test_torch_models import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_FRAMES = 3
IMAGE_HW = (1440, 1920)


def _cfg(make, out_dir, gt_dir):
    cfg = make()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]  # 200x200 cells at 0.1 m
    cfg.MAPPING.POINT_BUCKET = 2048
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.GROUND_TRUTH_DIR = str(gt_dir)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = 1.0 / 16
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.ASPP.OUT_CHANNELS = 32
    net.MODEL.ASPP.ATROUS_CHANNELS = [32, 32, 32, 32]
    net.MODEL.DECODER.REFINE_CHANNELS = [32, 32]
    return cfg


def _frames(rng):
    """A window of raw frames and clouds over the grid, vehicle behind it facing +x."""
    x0 = 100 - PCD_ORIGIN_OFFSET[0]
    y0 = 800 - PCD_ORIGIN_OFFSET[1]
    n = 2048
    xy = rng.uniform([[x0], [y0]], [[x0 + 20], [y0 + 20]], (N_FRAMES, 2, n))
    zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (N_FRAMES, 2, n))
    # a coarse random image: 90x120 blocks of 16x16 pixels
    coarse = rng.integers(0, 256, (N_FRAMES, 90, 120, 3), dtype=np.uint8)
    return {
        "image": coarse.repeat(16, axis=1).repeat(16, axis=2),
        "pcd": np.concatenate([xy, zi], axis=1).astype(np.float32),
        "valid": np.ones((N_FRAMES, n), bool),
        "position": np.tile(np.float32([x0 - 6.0, y0 + 10.0, 0.0]), (N_FRAMES, 1)),
        "quaternion": np.tile(np.float32([0, 0, 0, 1]), (N_FRAMES, 1)),
    }


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    rng = np.random.default_rng(21)
    out_dir = tmp_path_factory.mktemp("maps")
    gt_dir = tmp_path_factory.mktemp("truth")
    grid_hw = (200, 200)
    truth = rng.integers(0, 4, (grid_hw[0] // 10, grid_hw[1] // 10)).repeat(10, 0).repeat(10, 1)
    np.save(gt_dir / "truth.npy", truth.astype(np.float64))
    np.save(gt_dir / "mask.npy", np.ones(grid_hw))

    jcfg = _cfg(j_cfg_defaults, out_dir, gt_dir)
    cfg = _cfg(get_cfg_defaults, out_dir, gt_dir)
    jmodel = j_build_model(jcfg.VISION_SEM_SEG.SEM_SEG_NETWORK)[0]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 90, 120, 3)))
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    frames = _frames(rng)
    # A random network gives every pixel the class with the largest mean
    # logit.  Centre the logits on frame 0 and hold the unmapped classes
    # back a little, so that points take several map channels and some none.
    seg = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32)._build_segmentation(
        "camera1", IMAGE_HW)
    logits = np.asarray(seg(variables, jnp.asarray(frames["image"][0])))[0]
    head = variables["params"]["decoder"]["refine_layers_2"]["conv"]
    unmapped = ~np.isin(np.arange(19), jcfg.LABELS)
    head["bias"] = (head["bias"] - logits.mean((0, 1))
                    - unmapped * 0.5 * logits.std((0, 1))).astype(np.float32)

    jpipe = JaxPipeline(jcfg, variables, compute_dtype=jnp.float32, distortion="points")
    run = jpipe.build_sequence_runner(image_hw=IMAGE_HW)
    j_grid = np.asarray(run(jpipe.init_grid(), {k: jnp.asarray(v) for k, v in frames.items()}))
    j_map = JaxReplay(jcfg, engine=jpipe.engine).finalize(j_grid, "jax", use_pallas=False)

    pipe = FusedFramePipeline(cfg, state_dict=flax_to_state_dict(variables),
                              compute_dtype=torch.float32, distortion="points", device="cpu")
    grid = pipe.run_window(pipe.init_grid(), {k: torch.from_numpy(v) for k, v in frames.items()})
    replay = MappingReplay(cfg, engine=pipe.engine, device="cpu")
    t_map = replay.finalize(grid, "port")
    return dict(j_grid=j_grid, grid=grid.numpy(), j_map=j_map, map=t_map, gt_dir=str(gt_dir),
                out_dir=replay.output_dir)


def test_grid_matches(slice_run):
    grid, j_grid = slice_run["grid"], slice_run["j_grid"]
    assert (j_grid != 0).sum() > 100  # the window put evidence into the grid
    np.testing.assert_allclose(grid, j_grid, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(grid != 0, j_grid != 0)


def test_rendered_map_matches(slice_run):
    t_map, j_map = slice_run["map"], slice_run["j_map"]
    assert t_map.shape == j_map.shape == (200, 200, 3) and t_map.dtype == np.uint8
    assert (t_map.sum(-1) > 0).mean() > 0.01
    mismatch = (t_map != j_map).any(-1).mean()
    assert mismatch <= 1e-3, f"maps differ on {mismatch:.5f} of cells"
    # finalize wrote the PNG; cv2 reads back the array it was given
    import cv2

    np.testing.assert_array_equal(cv2.imread(f"{slice_run['out_dir']}/global_map_port.png"), t_map)


def test_scores_match(slice_run):
    ours = MapEvaluator(ground_truth_dir=slice_run["gt_dir"]).test_single_map(slice_run["map"])
    ref = JaxEvaluator(ground_truth_dir=slice_run["gt_dir"]).test_single_map(slice_run["j_map"])
    np.testing.assert_equal(ours, ref)
    assert all(v > 0 for v in ours["iou"].values())  # every scored class was mapped
