"""Port parity: the segmentation network against the JAX package's flax modules.

Variables come from the flax module's ``init``; BatchNorm scale, bias and
running statistics are then redrawn with numpy, so that BatchNorm is not
the identity.  They cross into the port through ``flax_to_state_dict`` and
load with ``strict=True``.  Both sides run in f32 on the CPU; outputs agree
to 1e-4 (the same arithmetic, summed in another order).  On the CPU the
ASPP's atrous depthwise convs run K4's plain version (K3's with a single
atrous branch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.models import aspp as j_aspp
from vision_semantic_segmentation_tpu.models import decoder as j_decoder
from vision_semantic_segmentation_tpu.models import deeplab as j_deeplab
from vision_semantic_segmentation_tpu.models import resnet as j_resnet
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.models.convert import torch_state_dict_to_flax
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import (
    ASPP,
    Decoder,
    DeepLabV3Plus,
    ResNetBackbone,
    build_model,
    flax_to_state_dict,
)
from vision_semantic_segmentation_tpu_torch.models.layers import DepthwiseConv2d
from vision_semantic_segmentation_tpu_torch.models.resnet import BasicBlock, Bottleneck
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise as dw_kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ATOL = 1e-4


@pytest.fixture
def rng():
    """A fixed seed for each test, whatever else ran before it in the worker."""
    return np.random.default_rng(0)


def _randomize_bn(tree, rng):
    """Numpy copy of a flax variable tree with BatchNorm drawn at random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
            continue
        v = np.asarray(v, dtype=np.float32)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _init(module, rng, *inputs, **kw):
    variables = module.init(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                            *map(jnp.asarray, inputs), **kw)
    return _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)


def _port(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW view in channels-last memory (the port's layout)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_close(ours: np.ndarray, ref) -> None:
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


class TestConvert:
    @pytest.mark.parametrize("backbone,os_", [("resnet18", 16), ("resnet50", 8)])
    def test_roundtrip_and_strict_load(self, rng, backbone, os_):
        jmodel = j_deeplab.DeepLabV3Plus(out_channels=7, backbone=backbone, output_stride=os_)
        variables = _init(jmodel, rng, np.zeros((1, 33, 33, 3), np.float32))
        sd = flax_to_state_dict(variables)
        model = DeepLabV3Plus(out_channels=7, backbone=backbone, output_stride=os_)
        model.load_state_dict(sd, strict=True)
        back = torch_state_dict_to_flax(sd)
        flat_a = jax.tree_util.tree_leaves_with_path(variables)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)

    def test_index_names(self, rng):
        jmodel = j_deeplab.DeepLabV3Plus(out_channels=7, backbone="resnet18", output_stride=8)
        sd = flax_to_state_dict(_init(jmodel, rng, np.zeros((1, 33, 33, 3), np.float32)))
        for key in ("backbone.layer1.0.conv1.weight", "backbone.layer2.0.downsample.1.running_var",
                    "aspp.module_pyramid.2.depthwise_cnn.conv.weight",
                    "aspp.global_avg_pool.1.bn.weight", "decoder.refine_layers.0.pointwise_cnn.bn.bias",
                    "decoder.refine_layers.2.conv.bias"):
            assert key in sd, key
        # depthwise (3, 3, 1, C) -> (C, 1, 3, 3)
        assert sd["aspp.module_pyramid.1.depthwise_cnn.conv.weight"].shape == (512, 1, 3, 3)

    def test_flagship_tree_loads_strict(self):
        """The deployed ResNeXt50-32x4d OS8 tree (shapes only) loads into the port's model."""
        net_cfg = j_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
        jmodel = j_build_model(net_cfg)[0]
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        )
        variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
        model = build_model(get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK, device="cpu")
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        grouped = model.backbone.layer1[0].conv2
        assert grouped.groups == 32 and grouped.weight.shape == (128, 4, 3, 3)


class TestBlocks:
    @pytest.mark.parametrize("stride,dilation,downsample", [(1, 1, False), (2, 1, True), (1, 2, True)])
    def test_basic_block(self, rng, stride, dilation, downsample):
        inplanes = 16 if not downsample else 8
        x = rng.standard_normal((1, 13, 11, inplanes)).astype(np.float32)
        jblock = j_resnet.BasicBlock(planes=16, stride=stride, dilation=dilation,
                                     downsample=downsample)
        variables = _init(jblock, rng, x)
        ref = jblock.apply(variables, jnp.asarray(x))
        block = _port(BasicBlock(inplanes, 16, stride, dilation, downsample), variables)
        _assert_close(_nhwc(block(_nchw(x))), ref)

    @pytest.mark.parametrize("groups,width,stride,dilation", [(1, 64, 1, 1), (32, 4, 2, 1), (32, 4, 1, 2)])
    def test_bottleneck(self, rng, groups, width, stride, dilation):
        x = rng.standard_normal((1, 12, 10, 64)).astype(np.float32)
        kw = dict(stride=stride, dilation=dilation, groups=groups, base_width=width, downsample=True)
        jblock = j_resnet.Bottleneck(planes=32, **kw)
        variables = _init(jblock, rng, x)
        ref = jblock.apply(variables, jnp.asarray(x))
        block = _port(Bottleneck(64, 32, **kw), variables)
        _assert_close(_nhwc(block(_nchw(x))), ref)

    def test_grouped_backbone_os8(self, rng):
        """ResNeXt-style backbone (32 groups of width 4), stages 3+4 dilated."""
        kw = dict(layers=(1, 1, 1, 1), groups=32, width_per_group=4,
                  replace_stride_with_dilation=(False, True, True))
        x = rng.standard_normal((1, 40, 36, 3)).astype(np.float32)
        jnet = j_resnet.ResNetBackbone(**kw)
        variables = _init(jnet, rng, x)
        ref = jnet.apply(variables, jnp.asarray(x))
        out = _port(ResNetBackbone(**kw), variables)(_nchw(x))
        for name in ("feature", "low_feature"):
            _assert_close(_nhwc(out[name]), ref[name])
        assert out["feature"].shape[-2:] == (5, 5)  # output stride 8


def _spy_depthwise(monkeypatch):
    """Count the ASPP's per-frame K4 and K3 calls (their plain route on the
    CPU), which ``DepthwiseBranches`` makes for the layer."""
    calls = {"K4": 0, "K3": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(dw_kernels, "_k4", spy("K4", dw_kernels._k4))
    monkeypatch.setattr(dw_kernels, "_k3", spy("K3", dw_kernels._k3))
    return calls


class TestHeads:
    @pytest.mark.parametrize("dilations", [(1, 2, 3, 5), (1, 12, 24, 36)])
    def test_aspp(self, rng, dilations, monkeypatch):
        x = rng.standard_normal((1, 9, 11, 32)).astype(np.float32)
        kw = dict(out_channels=24, atrous_channels=(16, 8, 8, 8), atrous_dilation=dilations)
        jaspp = j_aspp.ASPP(**kw)
        variables = _init(jaspp, rng, x)
        ref = jaspp.apply(variables, jnp.asarray(x))
        aspp = _port(ASPP(32, **kw), variables)
        assert all(isinstance(b.depthwise_cnn.conv, DepthwiseConv2d) and b.depthwise_cnn.conv.uses_k3()
                   for b in aspp.module_pyramid[1:])
        assert aspp.fused_branches() == [1, 2, 3]
        calls = _spy_depthwise(monkeypatch)
        _assert_close(_nhwc(aspp(_nchw(x))), ref)
        assert calls == {"K4": 1, "K3": 0}  # the three atrous branches in one K4 call

    def test_aspp_one_atrous_branch_runs_k3(self, rng, monkeypatch):
        x = rng.standard_normal((1, 9, 11, 32)).astype(np.float32)
        kw = dict(out_channels=24, atrous_channels=(16, 8), atrous_kernel_size=(1, 3),
                  atrous_dilation=(1, 4))
        jaspp = j_aspp.ASPP(**kw)
        variables = _init(jaspp, rng, x)
        ref = jaspp.apply(variables, jnp.asarray(x))
        aspp = _port(ASPP(32, **kw), variables)
        calls = _spy_depthwise(monkeypatch)
        _assert_close(_nhwc(aspp(_nchw(x))), ref)
        assert calls == {"K4": 0, "K3": 1}

    def test_aspp_batch_of_two(self, rng):
        """Each frame of a batch takes its own K4 call; outputs stack per branch."""
        x = rng.standard_normal((2, 7, 8, 32)).astype(np.float32)
        kw = dict(out_channels=24, atrous_channels=(16, 8, 8, 8), atrous_dilation=(1, 2, 3, 5))
        jaspp = j_aspp.ASPP(**kw)
        variables = _init(jaspp, rng, x)
        ref = jaspp.apply(variables, jnp.asarray(x))
        _assert_close(_nhwc(_port(ASPP(32, **kw), variables)(_nchw(x))), ref)

    def test_decoder(self, rng):
        feat = rng.standard_normal((1, 5, 6, 24)).astype(np.float32)
        low = rng.standard_normal((1, 17, 21, 16)).astype(np.float32)
        kw = dict(low_level_out_channels=8, refine_channels=(16, 12))
        jdec = j_decoder.Decoder(out_channels=7, **kw)
        variables = _init(jdec, rng, feat, low)
        ref = jdec.apply(variables, jnp.asarray(feat), jnp.asarray(low))
        dec = _port(Decoder(24, 16, 7, **kw), variables)
        ours = _nhwc(dec(_nchw(feat), _nchw(low)))
        assert ours.shape == (1, 13, 17, 7)  # unpadded refine convs shrink by 4
        assert not dec.refine_layers[0].depthwise_cnn.conv.uses_k3()
        _assert_close(ours, ref)


class TestDeepLab:
    @pytest.mark.parametrize("os_,upsample", [(8, False), (16, True)])
    def test_resnet18(self, rng, os_, upsample):
        kw = dict(backbone="resnet18", output_stride=os_, aspp_atrous_channels=(32, 32, 32, 32),
                  aspp_out_channels=32, decoder_refine_channels=(32, 32))
        x = rng.standard_normal((1, 49, 57, 3)).astype(np.float32)
        jmodel = j_deeplab.DeepLabV3Plus(out_channels=19, **kw)
        variables = _init(jmodel, rng, x)
        ref = jmodel.apply(variables, jnp.asarray(x), upsample_pred=upsample)
        model = _port(DeepLabV3Plus(out_channels=19, **kw), variables)
        with torch.no_grad():
            ours = _nhwc(model(_nchw(x), upsample_pred=upsample))
        _assert_close(ours, ref)
        np.testing.assert_array_equal(ours.argmax(-1), np.asarray(ref).argmax(-1))

    def test_dummy_registry(self, rng):
        cfg = get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
        cfg.MODEL.TYPE = "Dummy"
        jcfg = j_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
        jcfg.MODEL.TYPE = "Dummy"
        x = rng.standard_normal((1, 10, 12, 3)).astype(np.float32)
        jnet = j_build_model(jcfg)[0]
        variables = _init(jnet, rng, x)
        ref = jnet.apply(variables, jnp.asarray(x))
        model = build_model(cfg, device="cpu")
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        _assert_close(_nhwc(model(_nchw(x))), ref)

    def test_build_model_seeded(self):
        cfg = get_cfg_defaults().VISION_SEM_SEG.SEM_SEG_NETWORK
        cfg.MODEL.BACKBONE = "resnet18"
        a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb
            torch.testing.assert_close(va, vb, rtol=0, atol=0)
        assert not a.training
