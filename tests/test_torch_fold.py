"""The serving forward with eval BatchNorm folded (``models/fold.py``) against
the modules run as they are, on the CPU in f32.

Every site form (conv + BN + ReLU, the residual tails with and without a
downsample conv, the depthwise BN folded into the pointwise conv after the
TF "same" pre-pad and after the stride-2 zero pad, the pointwise conv into
a sum skip and the low-level tap) runs its plain PyTorch version here and
agrees with the unfolded module to 1e-5 of the output's largest magnitude:
the same arithmetic with the affine moved into the weights, rounded in f32.
BatchNorm statistics, weights and shifts are drawn at random, and the last
BatchNorm of each residual branch has weight 5000, as the Xception-65
cell seeds it.  The whole ResNeXt50 OS8 and Xception-65 DeepLabV3+ agree
at a 96x128 frame, and run their modules' own forwards folded (an edited
block forward reaches both); ``FoldInfo`` names what folds; a changed weight or
statistic refolds, and nothing else does; the modules and every caller
that runs them (training, ``params``, the pipeline's unkeyed calls) stay
bit for bit as they were.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import (
    BatchNorm2d,
    ConvBNReLU,
    DeepLabV3Plus,
    DepthwiseSeparableConv,
    XceptionBlock,
    init_weights_,
)
from vision_semantic_segmentation_tpu_torch.models import fold
from vision_semantic_segmentation_tpu_torch.models.resnet import BasicBlock, Bottleneck
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

RTOL = 1e-5
RESIDUAL_BN_WEIGHT = 5000.0


def _residual_norms(module: nn.Module):
    """The last BatchNorm of each residual branch in ``module``."""
    for m in module.modules():
        if isinstance(m, Bottleneck):
            yield m.bn3
        elif isinstance(m, BasicBlock):
            yield m.bn2
        elif isinstance(m, XceptionBlock):
            yield m.residual_group2[-1].pointwise_cnn.bn


def _randomized(module: nn.Module, seed: int = 0,
                residual_bn_weight: float = RESIDUAL_BN_WEIGHT) -> nn.Module:
    """``module`` in eval, channels-last, with He weights, random conv
    biases and random BatchNorm (the residual branches' last weight
    ``residual_bn_weight``)."""
    g = torch.Generator().manual_seed(seed)
    init_weights_(module, g)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        for bn in _residual_norms(module):
            bn.weight.fill_(residual_bn_weight)
    return module.to(memory_format=torch.channels_last).eval()


def _input(shape, seed=1):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return x.contiguous(memory_format=torch.channels_last)


def _assert_close(got, want):
    if isinstance(want, (tuple, list)):
        for a, b in zip(got, want, strict=True):
            _assert_close(a, b)
        return
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RTOL, err


# module, input shape, FoldInfo (folded, unfolded, calls)
SITES = {
    "conv_relu_3x3_same_stride2": (
        lambda: ConvBNReLU(8, 16, 3, stride=2, padding="same", bn=True, relu=True),
        (1, 8, 15, 17), (1, 0, {"conv_relu": 1})),
    "conv_relu_7x7_stride2": (
        lambda: ConvBNReLU(3, 16, 7, stride=2, padding=3, bn=True, relu=True),
        (1, 3, 20, 22), (1, 0, {"conv_relu": 1})),
    "conv_relu_1x1": (
        lambda: ConvBNReLU(16, 24, 1, bn=True, relu=True),
        (1, 16, 9, 11), (1, 0, {"conv_relu": 1})),
    "conv_relu_32_groups_dilated": (
        lambda: ConvBNReLU(64, 64, 3, padding=2, dilation=2, groups=32, bn=True, relu=True),
        (1, 64, 9, 11), (1, 0, {"conv_relu": 1})),
    "gemm_bias_1x1_no_relu": (
        lambda: ConvBNReLU(16, 24, 1, bn=True),
        (1, 16, 9, 11), (1, 0, {"gemm_bias": 1})),
    "bn_stays_3x3_no_relu": (
        lambda: ConvBNReLU(16, 24, 3, padding=1, bn=True),
        (1, 16, 9, 11), (0, 1, {})),
    "depthwise_relu_stays": (
        lambda: ConvBNReLU(16, 16, 3, groups=16, bn=True, relu=True),
        (1, 16, 9, 11), (0, 1, {})),
    "bottleneck_tail": (
        lambda: Bottleneck(64, 16, groups=4, base_width=16),
        (1, 64, 9, 11), (3, 0, {"conv_add_relu": 1, "conv_relu": 2})),
    "bottleneck_tail_downsample_stride2": (
        lambda: Bottleneck(32, 16, stride=2, downsample=True, groups=4, base_width=16),
        (1, 32, 9, 11), (4, 0, {"conv": 1, "conv_add_relu": 1, "conv_relu": 2})),
    "bottleneck_tail_downsample_dilated": (
        lambda: Bottleneck(32, 16, dilation=2, downsample=True, groups=4, base_width=16),
        (1, 32, 9, 11), (4, 0, {"conv": 1, "conv_add_relu": 1, "conv_relu": 2})),
    "basic_tail_downsample": (
        lambda: BasicBlock(16, 32, stride=2, downsample=True),
        (1, 16, 9, 11), (3, 0, {"conv": 1, "conv_add_relu": 1, "conv_relu": 1})),
    "separable_depthwise_bn_into_pointwise_same_stride2": (
        lambda: DepthwiseSeparableConv(16, 24, 3, stride=2, padding="same", depthwise_bn=True,
                                       pointwise_bn=True),
        (1, 16, 10, 13), (2, 0, {"gemm_bias": 1})),
    "separable_k3_depthwise_relu_stays": (
        lambda: DepthwiseSeparableConv(16, 24, 3, padding=2, dilation=2, depthwise_bn=True,
                                       pointwise_bn=True, depthwise_relu=True,
                                       pointwise_relu=True),
        (1, 16, 9, 11), (1, 1, {"conv_relu": 1})),
    "xception_entry_block_tap_zero_pad_conv_skip": (
        lambda: XceptionBlock(16, (24, 24, 24), (3, 3, 3), (1, 1, 2), (1, 1, 1),
                              skip_type="conv", skip_channels=24, skip_stride=2,
                              return_residual_features=True, add_residual_padding=True),
        (1, 16, 10, 13), (7, 0, {"conv": 1, "conv_relu": 1, "gemm_bias": 1,
                                 "gemm_bias_add": 1})),
    "xception_middle_block_sum_skip": (
        lambda: XceptionBlock(24, (24, 24, 24), (3, 3, 3), (1, 1, 1), (1, 1, 1),
                              skip_type="sum"),
        (1, 24, 9, 11), (6, 0, {"conv_relu": 2, "gemm_bias_add": 1})),
    "xception_exit_block_conv_skip_stride1": (
        lambda: XceptionBlock(24, (24, 32, 32), (3, 3, 3), (1, 1, 1), (1, 1, 1),
                              skip_type="conv", skip_channels=32),
        (1, 24, 9, 11), (7, 0, {"conv": 1, "conv_relu": 2, "gemm_bias_add": 1})),
    "xception_block_no_skip": (
        lambda: XceptionBlock(24, (24, 24), (3, 3), (1, 1), (1, 1), entry_relu=False),
        (1, 24, 9, 11), (4, 0, {"conv_relu": 1, "gemm_bias": 1})),
}


@pytest.mark.parametrize("case", sorted(SITES))
def test_folded_site_equals_unfolded(case):
    make, shape, (folded, unfolded, calls) = SITES[case]
    module = _randomized(make())
    x = _input(shape)
    net = fold.FoldedNetwork(module)
    with torch.no_grad():
        _assert_close(net(x), module(x))
    assert net.info() == fold.FoldInfo(folded, unfolded, 0, calls)


FORMS = [  # (kernel, stride, groups, depthwise?) x epilogue -> form
    ((1, 1, 1), {"relu": "conv_relu", "add_relu": "conv_add_relu", "bias": "gemm_bias",
                 "add": "gemm_bias_add", "none": "conv"}),
    ((1, 2, 1), {"relu": "conv_relu", "add_relu": "conv_add_relu", "bias": None,
                 "add": None, "none": "conv"}),
    ((3, 1, 1), {"relu": "conv_relu", "add_relu": "conv_add_relu", "bias": None,
                 "add": None, "none": "conv"}),
    ((7, 2, 1), {"relu": "conv_relu", "bias": None}),
    ((3, 1, 32), {"relu": "conv_relu", "add_relu": "conv_add_relu"}),
    ((3, 1, 64), {"relu": None, "bias": None}),
    ((3, 2, 64), {"relu": None, "none": None}),
]


@pytest.mark.parametrize("conv,epilogue", [(c, e) for c, forms in FORMS for e in forms])
def test_site_form_follows_the_conv_and_its_epilogue(conv, epilogue):
    k, stride, groups = conv
    want = dict(FORMS)[conv][epilogue]
    module = nn.Conv2d(64, 64, k, stride=stride, padding=k // 2, groups=groups, bias=False)
    assert fold.site_form(module, epilogue) == want
    with pytest.raises(ValueError):
        fold.site_form(module, "relu6")


# -- whole networks ---------------------------------------------------------------------
NETWORKS = {
    # backbone, output stride, low-level channels, residual BN weight (the cells'), FoldInfo
    "resnext50_32x4d": (8, 256, 1.0, fold.FoldInfo(
        62, 5, 0, {"conv": 4, "conv_add_relu": 16, "conv_relu": 42})),
    "xception65": (16, 48, RESIDUAL_BN_WEIGHT, fold.FoldInfo(
        138, 8, 0, {"conv": 4, "conv_relu": 53, "gemm_bias": 1, "gemm_bias_add": 20})),
}
# the BatchNorms left as passes: every depthwise BN a ReLU follows (ASPP's K4
# branches, Xception's K3 exit convs, the decoder's cuDNN refine convs)
UNFOLDED = {
    "resnext50_32x4d": {f"aspp.module_pyramid.{i}.depthwise_cnn.bn" for i in (1, 2, 3)}
    | {f"decoder.refine_layers.{i}.depthwise_cnn.bn" for i in (0, 1)},
    "xception65": {f"aspp.module_pyramid.{i}.depthwise_cnn.bn" for i in (1, 2, 3)}
    | {f"decoder.refine_layers.{i}.depthwise_cnn.bn" for i in (0, 1)}
    | {f"backbone.exit_flow_modules.{i}.depthwise_cnn.bn" for i in (1, 2, 3)},
}


@pytest.fixture(scope="module", params=sorted(NETWORKS))
def network(request):
    backbone = request.param
    output_stride, low, residual_bn_weight, _ = NETWORKS[backbone]
    model = _randomized(DeepLabV3Plus(19, backbone, output_stride,
                                      decoder_low_level_out_channels=low),
                        residual_bn_weight=residual_bn_weight)
    return backbone, model


def test_folded_network_equals_unfolded(network):
    _, model = network
    x = _input((1, 3, 96, 128))
    net = fold.FoldedNetwork(model)
    with torch.no_grad():
        for upsample_pred in (False, True):
            _assert_close(net(x, upsample_pred=upsample_pred),
                          model(x, upsample_pred=upsample_pred))


def test_fold_info_names_every_batchnorm(network):
    backbone, model = network
    net = fold.FoldedNetwork(model)
    info = net.info()
    assert info == NETWORKS[backbone][3]
    names = {m: n for n, m in model.named_modules()}
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert info.folded + info.unfolded == len(norms)
    assert {names[m] for m in net._unfolded} == UNFOLDED[backbone]


def test_the_folded_forward_is_the_modules_forward(network, monkeypatch):
    """One forward: folded, the network runs its modules' own forwards, so
    an edit to one (each residual block without a shortcut conv skipped)
    reaches the folded forward as it reaches the unfolded one."""
    backbone, model = network
    x = _input((1, 3, 96, 128))
    net = fold.FoldedNetwork(model)
    with torch.no_grad():
        before = net(x)
        block = Bottleneck if backbone == "resnext50_32x4d" else XceptionBlock
        forward = block.forward
        monkeypatch.setattr(block, "forward", lambda self, h: h if (
            getattr(self, "downsample", None) is None
            and getattr(self, "skip_type", "sum") == "sum") else forward(self, h))
        got, want = net(x), model(x)
    _assert_close(got, want)
    assert not torch.allclose(got, before)


# -- refolds ----------------------------------------------------------------------------
def _small_network(seed=0):
    return _randomized(DeepLabV3Plus(19, "resnet18", 8, aspp_out_channels=32,
                                     aspp_atrous_channels=(32, 32, 32, 32),
                                     decoder_refine_channels=(32, 32)), seed, 1.0)


CHANGES = {
    "load_state_dict": lambda model: model.load_state_dict(_small_network(seed=7).state_dict()),
    "in_place_weight": lambda model: model.backbone.layer2[0].conv2.weight.mul_(1.5),
    "in_place_running_var": lambda model: model.aspp.conv.bn.running_var.add_(0.25),
    "in_place_pointwise_bn": lambda model: model.aspp.module_pyramid[1].pointwise_cnn.bn.bias
    .add_(0.5),
    "parameter_replaced": lambda model: setattr(
        model.backbone.layer1[0], "conv1",
        _replaced_conv(model.backbone.layer1[0].conv1)),
}


def _replaced_conv(conv):
    """The same conv module, its weight a new Parameter of other values."""
    conv.weight = nn.Parameter(conv.weight.detach() * 0.5)
    return conv


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_changed_source_refolds_in_place_and_nothing_else_does(change):
    model = _small_network()
    x = _input((1, 3, 64, 96))
    net = fold.FoldedNetwork(model)
    addresses = [(s.weight.data_ptr(), s.bias.data_ptr()) for s in net._sites.values()]
    for _ in range(3):
        assert not net.refresh()
    with torch.no_grad():  # an in-place edit under no_grad (through ``.data`` none is seen)
        before = net(x)
        CHANGES[change](model)
    assert net.refresh()
    assert not net.refresh()
    assert net.info().refolds == 1
    assert [(s.weight.data_ptr(), s.bias.data_ptr()) for s in net._sites.values()] == addresses
    with torch.no_grad():
        got, want = net(x), model(x)
    _assert_close(got, want)
    assert not torch.equal(got, before)


# -- what stays as it was ------------------------------------------------------------------
def test_the_model_and_its_callers_stay_unfolded():
    """Folding reads the model and changes nothing: its state, its eval and
    training forwards and a ``functional_call`` with other weights give an
    untouched copy's bits."""
    model = _small_network()
    copied = copy.deepcopy(model)
    x = _input((2, 3, 64, 96))
    net = fold.FoldedNetwork(model)
    with torch.no_grad():
        net(x)
    for (k, a), (_, b) in zip(model.state_dict().items(), copied.state_dict().items(),
                              strict=True):
        assert torch.equal(a, b), k
    params = _small_network(seed=3).state_dict()
    with torch.no_grad():
        assert torch.equal(model(x), copied(x))
        assert torch.equal(torch.func.functional_call(model, params, (x,)),
                           torch.func.functional_call(copied, params, (x,)))
    model.train()
    copied.train()
    torch.manual_seed(0)
    got = model(x)
    torch.manual_seed(0)
    assert torch.equal(got, copied(x))


def _pipeline():
    cfg = get_cfg_defaults()
    cfg.MAPPING.BOUNDARY = [[100, 120], [800, 820]]
    cfg.MAPPING.POINT_BUCKET = 2048
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = "resnet18"
    net.MODEL.OUTPUT_STRIDE = 8
    net.MODEL.ASPP.OUT_CHANNELS = 32
    net.MODEL.ASPP.ATROUS_CHANNELS = [32, 32, 32, 32]
    net.MODEL.DECODER.REFINE_CHANNELS = [32, 32]
    net.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 48
    pipe = FusedFramePipeline(cfg, compute_dtype=torch.float32, device="cpu",
                              generator=torch.Generator().manual_seed(4))
    _randomized(pipe.model, residual_bn_weight=1.0)
    frames = np.random.default_rng(3).integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    return pipe, torch.from_numpy(frames)


def test_folding_calls_fold_and_others_run_the_modules(monkeypatch):
    """On the CPU no call folds; with the card's decision stood in (an eval
    call without ``params`` folds, eagerly), each such call runs the folded
    forward, folded once and refolded once after ``load_state_dict``; a CPU
    call, one with ``params`` and one in training give the modules' bits."""
    pipe, frames = _pipeline()
    assert pipe.fold_info() == fold.FoldInfo(0, 0, 0, {})
    with torch.no_grad():
        assert torch.equal(pipe.segment(frames[0]), pipe._forward(frames[0], "camera1", None))
    assert pipe.fold_info() == fold.FoldInfo(0, 0, 0, {})
    monkeypatch.setattr(FusedFramePipeline, "_folds", lambda self, frame, params: (
        params is None and not self.model.training))
    monkeypatch.setattr(FusedFramePipeline, "_graph_key", lambda self, frame, camera, params: None)

    def folded_logits(frame):
        xf = ((frame.float() / 255.0 - pipe._mean) / pipe._std).permute(2, 0, 1)[None]
        with torch.no_grad():
            return fold.FoldedNetwork(pipe.model)(xf, upsample_pred=pipe.upsample_pred)

    with torch.no_grad():
        got = [pipe.segment(frame) for frame in frames]
    for frame, logits in zip(frames, got, strict=True):
        assert torch.equal(logits, folded_logits(frame))
    info = pipe.fold_info()
    assert (info.folded, info.unfolded, info.refolds) == (29, 5, 0)
    assert pipe.segment_graph_info() == (0, 0, 4, 0)

    pipe.model.load_state_dict(_small_network(seed=9).state_dict())
    with torch.no_grad():
        got = pipe.segment(frames[1])
        assert torch.equal(got, folded_logits(frames[1]))
        unfolded = pipe.model(((frames[1].float() / 255.0 - pipe._mean) / pipe._std)
                              .permute(2, 0, 1)[None], upsample_pred=pipe.upsample_pred)
        _assert_close(got, unfolded)
        params = dict(pipe.model.state_dict())
        assert torch.equal(pipe.segment(frames[1], params=params), unfolded)
    assert pipe.fold_info().refolds == 1
    pipe.model.train()
    torch.manual_seed(0)
    got = pipe.segment(frames[2])
    torch.manual_seed(0)
    want = pipe._forward(frames[2], "camera1", None)
    assert torch.equal(got, want)
    assert pipe.fold_info().refolds == 1  # a training call neither folds nor refolds
