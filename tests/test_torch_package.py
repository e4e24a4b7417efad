"""The port stands alone: it imports neither JAX nor the JAX package, its
configuration copy keeps the JAX package's keys and defaults, and its entry
points default to the card and refuse to start without one."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vision_semantic_segmentation_tpu_torch as port
from vision_semantic_segmentation_tpu import config as j_config
from vision_semantic_segmentation_tpu_torch import config
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine
from vision_semantic_segmentation_tpu_torch.models import build_model
from vision_semantic_segmentation_tpu_torch.models.build import Dummy
from vision_semantic_segmentation_tpu_torch.parallel import create_mesh, make_spatial_forward
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation
from vision_semantic_segmentation_tpu_torch.runtime import (
    FusedFramePipeline,
    FusedOnlineNode,
    MappingNode,
    MappingReplay,
    SegmentationNode,
    TopicBus,
)
from vision_semantic_segmentation_tpu_torch.__main__ import main as cli_main
from vision_semantic_segmentation_tpu_torch.runtime.async_bus import run_online
from vision_semantic_segmentation_tpu_torch.runtime.profiling import profile_stages
from vision_semantic_segmentation_tpu_torch.runtime.serving_pareto import score_quality, sweep_fps
from vision_semantic_segmentation_tpu_torch.runtime.tuning import tune
from vision_semantic_segmentation_tpu_torch.runtime.video import generate_video
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import vision_semantic_segmentation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vision_semantic_segmentation_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_jax_imports():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    walked = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    assert set(result["modules"]) == walked and len(walked) > 20
    online = {"inference.predictor", "ops.warp", "ops.kernels.depthwise_hoist", "runtime.bus",
              "runtime.node", "utils.logger", "utils.file_io", "models.quant",
              "ops.kernels.int8_conv", "runtime.native_io", "train.tensorboard_util",
              "train.datasets.bdd", "train.datasets.pascal", "train.datasets.preparation",
              "models.xception", "runtime.export", "runtime.serving_pareto",
              "parallel.spatial_infer"}
    assert {f"{port.__name__}.{m}" for m in online} <= walked
    assert result["bad"] == []


_NO_CV2_PROBE = """
import importlib, pkgutil, sys
import numpy as np, torch
import vision_semantic_segmentation_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from vision_semantic_segmentation_tpu_torch.geometry import warp_perspective
from vision_semantic_segmentation_tpu_torch.inference import generate_convex_hull
labels = np.zeros((40, 50), np.int32)
labels[10:30, 10:40] = 1
assert len(generate_convex_hull(labels)) == 1
warp_perspective(torch.zeros((8, 8, 3), dtype=torch.uint8), np.eye(3), (8, 8), mode="nearest")
print(sorted(m for m in sys.modules if m.split(".")[0] == "cv2"))
"""


def test_hulls_and_warp_need_no_opencv():
    """The GPU machine has no OpenCV: no port module imports it, and the
    hull extraction and the planar warp run without it."""
    out = subprocess.run([sys.executable, "-c", _NO_CV2_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_jax_in_chip_smoke():
    probe = (
        "import runpy, sys; runpy.run_path('chip_smoke.py', run_name='not_main'); "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'vision_semantic_segmentation_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_config_copy_matches():
    assert config.get_cfg_defaults() == j_config.get_cfg_defaults()
    assert config.get_demo_cfg_defaults() == j_config.get_demo_cfg_defaults()
    assert config.get_train_cfg_defaults() == j_config.get_train_cfg_defaults()


def _spatial(cfg):
    cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.SPATIAL_SHARDS = 4
    return cfg


def _xception(cfg):
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.TYPE, net.MODEL.OUTPUT_STRIDE = "Xception", 16
    return cfg


@pytest.mark.parametrize("entry", [
    lambda cfg: FusedFramePipeline(cfg),
    lambda cfg: MappingReplay(cfg),
    lambda cfg: SemanticMappingEngine(cfg),
    lambda cfg: build_model(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK),
    lambda cfg: SemanticSegmentation(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, state_dict={}),
    lambda cfg: SegmentationNode(cfg, TopicBus()),
    lambda cfg: MappingNode(cfg, TopicBus()),
    lambda cfg: FusedOnlineNode(cfg, TopicBus(), state_dict={}),
    lambda cfg: run_online(cfg, "drive.bag"),
    lambda cfg: cli_main(["replay", "--input-dir", "logs"]),
    lambda cfg: profile_stages(cfg),
    lambda cfg: generate_video(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, "drive.avi", cfg.OUTPUT_DIR),
    lambda cfg: cli_main(["profile"]),
    lambda cfg: tune(cfg),
    lambda cfg: sweep_fps(cfg, []),
    lambda cfg: score_quality(None, {"image_scale": 1.0, "backbone": "resnet18",
                                     "output_stride": 16, "upsample_pred": False}),
    lambda cfg: cli_main(["compile", "--out", f"{cfg.OUTPUT_DIR}/r.vsstexp"]),
    lambda cfg: cli_main(["autotune", "--out", f"{cfg.OUTPUT_DIR}/t.yaml"]),
    lambda cfg: cli_main(["autotune", "--serving", "--out", f"{cfg.OUTPUT_DIR}/s.yaml"]),
    lambda cfg: build_model(_xception(cfg).VISION_SEM_SEG.SEM_SEG_NETWORK),
    lambda cfg: make_spatial_forward(Dummy(19), create_mesh(axis_names=("grid",))),
    lambda cfg: SemanticSegmentation(_spatial(cfg).VISION_SEM_SEG.SEM_SEG_NETWORK, state_dict={}),
], ids=["pipeline", "replay", "engine", "build_model", "predictor", "segmentation_node",
        "mapping_node", "fused_online_node", "run_online", "cli", "profile_stages",
        "generate_video", "cli_profile", "tune", "sweep_fps", "score_quality", "cli_compile",
        "cli_autotune", "cli_autotune_serving", "build_xception", "make_spatial_forward",
        "spatial_predictor"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = config.get_cfg_defaults()
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(cfg)
