"""Port parity: the segmentation video demo (``runtime/video.py``, the
``video`` command) against the JAX package.

A 6-frame 48x64 MJPG written with cv2 goes through the JAX package's
``generate_video`` with the flax variables of a Dummy model in f32, and
through the port's with the same weights (``flax_to_state_dict``), on the
CPU.  Held equal: the two predictors' per-frame labels (measured: every
pixel of every frame), the two output videos' frame count and shape, and
their decoded frames; the ``video`` commands of both packages over one
demo YAML naming the weights as ``.npz`` write equal videos too.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_semantic_segmentation_tpu.__main__ import main as j_main
from vision_semantic_segmentation_tpu.config import get_demo_cfg_defaults as j_demo_defaults
from vision_semantic_segmentation_tpu.inference.predictor import (
    SemanticSegmentation as JaxPredictor,
    postprocess_labels as j_postprocess,
)
from vision_semantic_segmentation_tpu.models import build_model as j_build_model
from vision_semantic_segmentation_tpu.models.convert import save_npz
from vision_semantic_segmentation_tpu.runtime.video import generate_video as j_generate_video
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_demo_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation, postprocess_labels
from vision_semantic_segmentation_tpu_torch.runtime.video import generate_video

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N_FRAMES, H, W = 6, 48, 64


def _demo_cfg(make):
    cfg = make()
    cfg.MODEL.TYPE = "Dummy"
    cfg.DATASET.NUM_CLASSES = 19
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    return cfg


def _read(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The video (smooth colour blocks, so the decoded frames carry structure),
    the flax variables and their ``.npz``."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(12)
    path = root / "clip.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (W, H))
    for _ in range(N_FRAMES):
        writer.write(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8).repeat(8, 0).repeat(8, 1))
    writer.release()
    model = j_build_model(_demo_cfg(j_demo_defaults))[0]
    variables = jax.tree.map(np.asarray, dict(model.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3), jnp.float32))))
    weights = root / "weights.npz"
    save_npz(variables, str(weights))
    return root, path, variables, weights


def test_labels_and_videos_equal(clip):
    root, path, variables, _ = clip
    j_pred = JaxPredictor(_demo_cfg(j_demo_defaults), variables=variables,
                          compute_dtype="float32")
    pred = SemanticSegmentation(_demo_cfg(get_demo_cfg_defaults), variables=variables,
                                compute_dtype="float32", device="cpu")
    frames = _read(path)
    assert frames.shape == (N_FRAMES, H, W, 3)
    same = 0
    for bgr in frames:
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        want = np.asarray(j_postprocess(j_pred.segmentation(rgb), (H, W)))
        got = postprocess_labels(pred.labels(rgb), (H, W)).numpy()
        same += int((got == want).sum())
        assert len(np.unique(want)) > 1
    assert same == N_FRAMES * H * W

    j_out = j_generate_video(_demo_cfg(j_demo_defaults), str(path), str(root),
                             output_name="jax", predictor=j_pred)
    out = generate_video(_demo_cfg(get_demo_cfg_defaults), str(path), str(root),
                         output_name="port", predictor=pred)
    assert out == str(root / "port.avi")
    a, b = _read(out), _read(j_out)
    assert a.shape == b.shape == (N_FRAMES, H, W, 3)
    np.testing.assert_array_equal(a, b)


def test_cli(clip, capsys):
    root, path, _, weights = clip
    outs = {}
    for name, entry, extra in (("jax_cli", j_main, []), ("port_cli", main, ["--device", "cpu"])):
        cfg = _demo_cfg(get_demo_cfg_defaults)
        cfg.MODEL.WEIGHT = str(weights)
        cfg.OUTPUT_DIR = str(root / "cli")
        cfg.OUTPUT_NAME = name
        yaml = root / f"{name}.yaml"
        yaml.write_text(cfg.dump())
        (root / "cli").mkdir(exist_ok=True)
        entry(["video", "--cfg", str(yaml), "--video", str(path), *extra])
        outs[name] = _read(root / "cli" / f"{name}.avi")
        assert f"Wrote {N_FRAMES} frames to {root / 'cli' / name}.avi" in capsys.readouterr().out
    np.testing.assert_array_equal(outs["port_cli"], outs["jax_cli"])
