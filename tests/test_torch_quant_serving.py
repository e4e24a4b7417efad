"""Port parity: int8 serving (``models/quant.py``, the predictor's
``MODEL.QPACK`` and ``quantize()``, the ``quantize`` command).

A narrow DeepLabV3+ ResNet-18 OS16 (f32, seeded flax weights with drawn
BatchNorm statistics, saved as the JAX package's ``.npz``) and three 64x96
calibration frames (``.npz`` and the same frames as a ``.bag``) go through
both packages on the CPU.  Tolerances:

* DeepLabV3+ logits within 1e-4 of their scale, argmax equal on at least
  0.999 of the pixels (the JAX function run eagerly, fed its own qpack);
* the predictors' labels equal on at least 0.98 of the pixels: the JAX
  predictor jits its whole forward, XLA then contracts the requantize's
  multiply-adds into FMAs, which move ties by a level, and this random
  narrow network has near-tied logits; 0.95 between two qpacks calibrated
  apart (scales within 1e-5, which move ties too);
* the ``quantize`` command's calibration scales within 1e-5 (1e-3 when the
  frames are area-resized first: the two resizes round a few pixels
  apart), its kernels and BatchNorm arrays equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.__main__ import main as j_main
from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.inference.predictor import SemanticSegmentation as JSeg
from vision_semantic_segmentation_tpu.models import deeplab_from_cfg as j_deeplab_from_cfg
from vision_semantic_segmentation_tpu.models import quant as j_quant
from vision_semantic_segmentation_tpu.models.convert import save_npz as j_save_npz
from vision_semantic_segmentation_tpu_torch.__main__ import main
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation
from vision_semantic_segmentation_tpu_torch.inference.predictor import IMAGENET_MEAN, IMAGENET_STD
from vision_semantic_segmentation_tpu_torch.models import Dummy, deeplab_from_cfg
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict, quant
from vision_semantic_segmentation_tpu_torch.runtime import FrameRecord, rosbag, save_frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

from test_torch_quant import _assert_same_file_qpack, _randomize_bn, _torch_in


# -- DeepLabV3+, the predictor and the command ----------------------------------------------
def _narrow(net):
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.OUTPUT_STRIDE = 16
    net.MODEL.COMPUTE_DTYPE = "float32"
    net.DATASET.NUM_CLASSES = 5
    net.MODEL.ASPP.OUT_CHANNELS = 16
    net.MODEL.ASPP.ATROUS_CHANNELS = [16, 16, 16, 16]
    net.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 8
    net.MODEL.DECODER.REFINE_CHANNELS = [16, 16]


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    """A narrow DeepLabV3+ ResNet-18 OS16 (f32) as flax variables saved to
    ``.npz``, the YAML that names them, and calibration frames as ``.npz``
    and ``.bag``."""
    root = tmp_path_factory.mktemp("quant_net")
    rng = np.random.default_rng(41)
    cfg = j_cfg_defaults()
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    _narrow(net)
    cfg.VISION_SEM_SEG.IMAGE_SCALE = 1.0
    model = j_deeplab_from_cfg(net)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = _randomize_bn(variables, rng)
    net.MODEL.WEIGHT = str(root / "w.npz")
    j_save_npz(variables, net.MODEL.WEIGHT)
    frames = [FrameRecord(pcd=rng.uniform(0, 10, (4, 8)).astype(np.float32), pcd_frame_id="world",
                          semantic_image=rng.integers(0, 256, (64, 96, 3), dtype=np.uint8),
                          position=np.zeros(3, np.float32),
                          quaternion=np.array([0, 0, 0, 1], np.float32), camera="camera1",
                          stamp=1.0 + i) for i in range(3)]
    save_frames(frames, str(root / "calib.npz"))
    fields = [rosbag.PointField(n, 4 * i, 7, 1) for i, n in enumerate(("x", "y", "z", "intensity"))]
    msgs = []
    for f in frames:
        pts = np.ascontiguousarray(f.pcd.T)
        msgs += [("/reduced_map", rosbag.PointCloud2Msg(rosbag.Header(0, f.stamp, "world"), 1,
                                                        8, fields, 16, pts.tobytes()), f.stamp),
                 ("/current_pose", rosbag.PoseStampedMsg(rosbag.Header(0, f.stamp, "world"),
                                                         np.zeros(3), np.float64([0, 0, 0, 1])),
                  f.stamp),
                 ("/camera1/image_raw", rosbag.ImageMsg(rosbag.Header(0, f.stamp, "camera1"),
                                                        64, 96, "rgb8", f.semantic_image), f.stamp)]
    rosbag.write_bag(str(root / "calib.bag"), msgs)
    yamls = {}
    for scale in (1.0, 0.5):
        cfg.VISION_SEM_SEG.IMAGE_SCALE = scale
        yamls[scale] = str(root / f"cfg_{scale}.yaml")
        with open(yamls[scale], "w") as f:
            f.write(cfg.dump())
    return dict(root=root, model=model, variables=variables, frames=frames, yamls=yamls)


def _port_net_cfg(network, qpack=""):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(network["yamls"][1.0])
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.QPACK = qpack
    return net


def _jax_net_cfg(network):
    cfg = j_cfg_defaults()
    cfg.merge_from_file(network["yamls"][1.0])
    return cfg.VISION_SEM_SEG.SEM_SEG_NETWORK


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_quant_deeplab_forward_matches_jax(network):
    model, variables = network["model"], network["variables"]
    images = [f.semantic_image for f in network["frames"]]
    x = np.stack([(im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
                  for im in images[:2]])
    j_qpack = j_quant.quantize_deeplab(model, variables, [x[:1], x[1:]])
    path = str(network["root"] / "deeplab_qpack.npz")
    j_quant.save_qpack(j_qpack, path)
    port = deeplab_from_cfg(_port_net_cfg(network)).eval().to(memory_format=torch.channels_last)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables)), strict=True)
    qb = quant.QuantBackbone(port.backbone, quant.load_qpack(path, 1), torch.float32)
    # the upsampled logits: through the predictors, in test_predictor_serves_qpack_like_jax
    want = np.asarray(j_quant.quant_deeplab_apply(model, variables, j_qpack, jnp.asarray(x)))
    with torch.no_grad():
        got = quant.quant_deeplab_forward(port, qb, _torch_in(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert _agree(got.argmax(-1).numpy(), want.argmax(-1)) >= 0.999


def test_predictor_serves_qpack_like_jax(network):
    """Both predictors serve the JAX-written qpack through MODEL.QPACK, and
    ``quantize()`` calibrates as the JAX predictor does."""
    images = [f.semantic_image for f in network["frames"]]
    j_seg = JSeg(_jax_net_cfg(network))
    j_seg.quantize(images[:2])
    path = str(network["root"] / "predictor_qpack.npz")
    j_quant.save_qpack(j_seg.qpack, path)
    port = SemanticSegmentation(_port_net_cfg(network, qpack=path), device="cpu")
    assert port.qpack is not None and port.dtype == torch.float32
    for upsample in (False, True):
        for im in images:
            want = j_seg.segmentation(im, upsample_pred=upsample)
            got = port.segmentation(im, upsample_pred=upsample)
            assert got.dtype == np.int32 and got.shape == want.shape
            assert _agree(got, want) >= 0.98
    labels, conf = port.segmentation_with_confidence(images[0])
    assert labels.shape == conf.shape and conf.dtype == np.float32
    # quantize(): the port's calibration on the same frames
    own = SemanticSegmentation(_port_net_cfg(network), device="cpu")
    float_labels = own.segmentation(images[2])
    own.quantize(images[:2])
    for site, entry in j_seg.qpack.items():
        for field in ("in_scale", "out_scale"):
            if field in entry:
                assert float(own.qpack[site][field]) == pytest.approx(float(entry[field]),
                                                                      rel=1e-5)
    _assert_same_file_qpack({k: {f: v for f, v in e.items() if not f.endswith("_scale")
                                 or f.startswith(("w_", "bn_"))} for k, e in own.qpack.items()},
                            {k: {f: v for f, v in e.items() if f not in ("in_scale", "out_scale")}
                             for k, e in j_seg.qpack.items()})
    # scales 1e-5 apart move int8 ties too
    assert _agree(own.segmentation(images[2]), j_seg.segmentation(images[2])) >= 0.95
    assert _agree(own.segmentation(images[2]), float_labels) > 0.5


@pytest.mark.parametrize("scale,calib", [(1.0, "calib.npz"), (0.5, "calib.npz"),
                                         (1.0, "calib.bag")])
def test_quantize_command_matches_jax(network, scale, calib):
    """``quantize`` over .npz (and the same frames as a .bag) writes the JAX
    command's qpack, within calibration noise; the port's predictor serves it."""
    root = network["root"]
    out = str(root / f"port_{scale}_{calib}.npz")
    main(["quantize", "--cfg", network["yamls"][scale], "--calib", str(root / calib),
          "--frames", "2", "--out", out, "--device", "cpu"])
    j_out = str(root / f"jax_{scale}.npz")
    j_main(["quantize", "--cfg", network["yamls"][scale], "--calib", str(root / "calib.npz"),
            "--frames", "2", "--out", j_out])
    rel = 1e-5 if scale == 1.0 else 1e-3
    with np.load(out) as got, np.load(j_out) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            if key.endswith(("in_scale", "out_scale")):
                np.testing.assert_allclose(got[key], want[key], rtol=rel, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    seg = SemanticSegmentation(_port_net_cfg(network, qpack=out), device="cpu")
    labels = seg.segmentation(network["frames"][0].semantic_image)
    assert labels.dtype == np.int32 and labels.shape == (12, 20)


def test_qpack_needs_a_resnet_network(network):
    net = _port_net_cfg(network)
    net.MODEL.TYPE = "Dummy"
    net.MODEL.WEIGHT = ""
    dummy = SemanticSegmentation(net, state_dict=Dummy(5).state_dict(), device="cpu")
    with pytest.raises(ValueError, match="DeepLabV3"):
        dummy.quantize([network["frames"][0].semantic_image])


def test_bf16_predictor_quantizes_its_f32_weights(network):
    """A bf16 predictor loaded from ``MODEL.WEIGHT`` quantizes from the
    file's f32 weights, as the JAX package quantizes its f32 variables; one
    given the bf16-rounded weights quantizes those (other BatchNorm arrays)."""
    images = [f.semantic_image for f in network["frames"]]
    f32 = SemanticSegmentation(_port_net_cfg(network), device="cpu")
    f32.quantize(images[:2])
    bf16 = SemanticSegmentation(_port_net_cfg(network), compute_dtype="bfloat16", device="cpu")
    bf16.quantize(images[:2])
    for site, entry in f32.qpack.items():
        for field in ("w_q", "w_scale", "bn_scale", "bn_bias"):
            np.testing.assert_array_equal(bf16.qpack[site][field], entry[field],
                                          err_msg=f"{site}|{field}")
    rounded = SemanticSegmentation(_port_net_cfg(network), state_dict=bf16.model.state_dict(),
                                   compute_dtype="bfloat16", device="cpu")
    rounded.quantize(images[:2])
    assert any(not np.array_equal(rounded.qpack[s]["bn_scale"], e["bn_scale"])
               for s, e in f32.qpack.items())
