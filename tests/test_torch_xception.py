"""Port parity: Xception65 (``models/xception.py``) and the Xception
segmenter (``models/build.py``, ``MODEL.TYPE "Xception"``) against the JAX
package, in f32 on the CPU.

Weights cross both ways: a JAX block's flax variables go to the port through
``flax_to_state_dict``, and the port's whole Xception65 goes to the JAX
package by the reference's names (``tests/test_xception_parity.py::
_remap_keys``) and ``torch_state_dict_to_flax``, which is how a reference
``.pth`` loads.  BatchNorm scales, biases and statistics are drawn at
random, so every BatchNorm does work.  Outputs agree to 1e-5 of the
output's largest magnitude (f32 convolutions summed in another order; the
middle flow's sum skips grow a random network's activations by orders of
magnitude, so the bound is relative to the scale, as in the parity test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.models import build_model as j_build_model
from vision_semantic_segmentation_tpu.models import torch_state_dict_to_flax
from vision_semantic_segmentation_tpu.models.xception import Xception65 as JXception65
from vision_semantic_segmentation_tpu.models.xception import XceptionBlock as JXceptionBlock
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import (
    Xception65,
    XceptionBlock,
    XceptionSeg,
    build_model,
    flax_to_state_dict,
    init_weights_,
)
from vision_semantic_segmentation_tpu_torch.models.layers import DepthwiseConv2d

from test_xception_parity import _remap_keys
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

RTOL_OF_SCALE = 1e-5
# one input size for the whole-network cases: the JAX package runs them
# eagerly, and an eager op compiles once per shape
HW = (48, 80)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_SCALE * scale)


def _randomize_norms(variables, rng):
    """Random BatchNorm scale, bias, mean and (positive) variance."""
    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, kind)
            elif kind == "params" and k in ("scale", "bias"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "scale" \
                    else rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif kind == "batch_stats":
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32) if k == "mean" \
                    else rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return {kind: walk(tree, kind) for kind, tree in variables.items()}


def _port_randomized(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    init_weights_(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


BLOCKS = {  # variant -> (JAX kwargs, flax block name it is nested under, input channels)
    "conv_skip_padded_tap": (dict(
        residual_channels=(8, 8, 12), residual_kernel_size=(3, 3, 3),
        residual_stride=(1, 1, 2), residual_dilation=(1, 1, 1), skip_type="conv",
        skip_channels=12, skip_kernel=1, skip_stride=2, add_residual_padding=True,
        return_residual_features=True), "entry_block1", 4),
    "sum_skip": (dict(
        residual_channels=(8, 8, 8), residual_kernel_size=(3, 3, 3),
        residual_stride=(1, 1, 1), residual_dilation=(1, 1, 1), skip_type="sum"),
        "middle_block0", 8),
    "no_skip": (dict(
        residual_channels=(8, 6, 10), residual_kernel_size=(3, 3, 3),
        residual_stride=(1, 1, 1), residual_dilation=(1, 2, 1), skip_type=None),
        "middle_block3", 4),
    "no_entry_relu": (dict(
        residual_channels=(8, 8, 8), residual_kernel_size=(3, 3, 3),
        residual_stride=(1, 1, 1), residual_dilation=(1, 1, 1), skip_type="conv",
        skip_channels=8, entry_relu=False), "exit_block", 6),
}


@pytest.mark.parametrize("variant", sorted(BLOCKS))
def test_block_matches_jax(variant):
    kw, name, cin = BLOCKS[variant]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 9, 11, cin)).astype(np.float32)
    jblock = JXceptionBlock(**kw)
    variables = _randomize_norms(
        jax.tree.map(np.asarray, dict(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x)))), rng)
    ref = jblock.apply(variables, jnp.asarray(x))

    # the block's flax variables, as the named block of an Xception65
    sd = flax_to_state_dict({k: {name: v} for k, v in variables.items()})
    prefix = next(iter(sd)).split(".residual_group")[0] + "."
    sd = {k[len(prefix):]: v for k, v in sd.items()}
    block = XceptionBlock(cin, **kw).eval()
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = block(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    if kw.get("return_residual_features"):
        _close(out[0], ref[0])
        _close(out[1], ref[1])  # the pre-ReLU tap: it has negative values
        assert (np.asarray(ref[1]) < 0).any()
    else:
        _close(out, ref)


@pytest.fixture(scope="module")
def xception65():
    model = _port_randomized(Xception65(), seed=4)
    sd = model.state_dict()
    variables = torch_state_dict_to_flax(_remap_keys(sd))
    return model, sd, variables


def test_xception65_matches_jax(xception65):
    model, _, variables = xception65
    x = np.random.default_rng(5).standard_normal((1, *HW, 3)).astype(np.float32)
    ref = JXception65().apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert out["feature"].shape == (1, 2048, 3, 5) and out["low_feature"].shape == (1, 256, 12, 20)
    _close(out["feature"], ref["feature"])
    _close(out["low_feature"], ref["low_feature"])


def test_reference_layout_and_names(xception65):
    """The port's names are the reference's: ``_remap_keys`` maps every one
    of them, a depthwise weight crosses as (C, 1, 3, 3) <-> HWIO (3, 3, 1,
    C), and ``flax_to_state_dict`` inverts the JAX route exactly."""
    model, sd, variables = xception65
    dw = sd["middle_flow_modules.0.residual_group1.2.depthwise_cnn.conv.weight"]
    assert dw.shape == (728, 1, 3, 3)
    hwio = variables["params"]["middle_block0"]["residual_1"]["depthwise_cnn"]["conv"]["kernel"]
    assert hwio.shape == (3, 3, 1, 728)
    np.testing.assert_array_equal(hwio[:, :, 0, 5], dw[5, 0].numpy())
    back = flax_to_state_dict(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # 60 stride-1 depthwise convs run K3 (2 in each entry block, 48 in the
    # middle flow, 3 in the exit block, the 3 exit convs)
    sites = [m for m in model.modules() if isinstance(m, DepthwiseConv2d) and m.uses_k3()]
    assert len(sites) == 60


def test_output_stride_other_than_16_raises():
    with pytest.raises(NotImplementedError):
        Xception65(output_stride=8)


@pytest.fixture(scope="module")
def segmenter():
    """The port's ``XceptionSeg`` and the JAX one with the same weights, and
    the JAX logits without the resize."""
    j_cfg, cfg = j_cfg_defaults(), get_cfg_defaults()
    for c in (j_cfg, cfg):
        net = c.VISION_SEM_SEG.SEM_SEG_NETWORK
        net.MODEL.TYPE = "Xception"
        net.MODEL.OUTPUT_STRIDE = 16
    model = build_model(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu",
                        generator=torch.Generator().manual_seed(6))
    assert isinstance(model, XceptionSeg)
    model = _port_randomized(model, 6)
    sd = model.state_dict()
    backbone = _remap_keys({k[len("backbone."):]: v for k, v in sd.items()
                            if k.startswith("backbone.")})
    remapped = {**{f"backbone.{k}": v for k, v in backbone.items()},
                **{k: v for k, v in sd.items() if k.startswith("classifier.")}}
    variables = jax.tree.map(jnp.asarray, torch_state_dict_to_flax(remapped))
    jnet = j_build_model(j_cfg.VISION_SEM_SEG.SEM_SEG_NETWORK)[0]
    x = np.random.default_rng(7).standard_normal((1, *HW, 3)).astype(np.float32)
    logits = jnet.apply(variables, jnp.asarray(x), upsample_pred=False)
    return model, sd, variables, x, logits


@pytest.mark.parametrize("upsample_pred", [True, False])
def test_xception_segmenter_matches_jax(segmenter, upsample_pred):
    """With ``upsample_pred`` the JAX head resizes its f32 logits to the
    input (align corners); the same resize of the same logits is the
    reference here, so the network runs once in JAX for both cases."""
    from vision_semantic_segmentation_tpu.ops.resize import resize_align_corners

    model, sd, variables, x, logits = segmenter
    ref = resize_align_corners(logits.astype(jnp.float32), HW) if upsample_pred else logits
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2)), upsample_pred=upsample_pred)
    assert out.dtype == torch.float32
    assert out.shape[-2:] == (HW if upsample_pred else (3, 5))
    _close(out, ref)
    # the JAX variables come back to the port's names
    back = flax_to_state_dict(jax.tree.map(np.asarray, variables))
    assert set(back) == set(sd)
