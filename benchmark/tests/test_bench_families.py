"""A reference network of another family goes through everything the
harness derives from a network: the seeded weights, the classifier's
centring, the strict load of the check and the FLOP count.  The family is
defined here: a stem, a depthwise-separable residual block and a 1x1
classifier, described by a ``network`` object with none of ResNet's keys.
And the seeded weights of both configurations, pinned bit for bit."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from benchmark.core.checks import reference_network
from benchmark.core.weights import center_classifier, make_state_dict, state_shapes
from benchmark.counts.flops import forward_flops
from benchmark.reference import deeplab
from benchmark.run import load_reference
from benchmark.tests.conftest import REPO

TOY = '''
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.deeplab import Conv, ConvBNReLU, SeparableConv


class Toy(nn.Module):
    def __init__(self, net):
        super().__init__()
        c = net["channels"]
        self.stem = ConvBNReLU(3, c, 3, padding=1)
        self.block = SeparableConv(c, c, 3, padding=net["dilation"], dilation=net["dilation"])
        self.head = ConvBNReLU(c, net["num_classes"], 1, bn=False, relu=False)

    def set_quant(self, quant, grad_quant=None):
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant, m.grad_quant = quant, grad_quant

    def forward(self, x, upsample=False):
        y = self.stem(F.avg_pool2d(x, 2))
        logits = self.head(F.relu(y + self.block(y)))
        if upsample:
            logits = F.interpolate(logits, size=x.shape[-2:], mode="bilinear",
                                   align_corners=True)
        return logits


def network(net):
    return Toy(net)


def classifier_bias(net):
    return "head.conv.bias"


def residual_bn_weights(net, keys):
    return {k for k in keys if k == "block.pointwise_cnn.bn.weight"}
'''
NET = {"reference": "toy", "channels": 8, "dilation": 2, "num_classes": 5}


@pytest.fixture
def toy(tmp_path):
    (tmp_path / "benchmark" / "reference").mkdir(parents=True)
    (tmp_path / "benchmark" / "reference" / "toy.py").write_text(TOY)
    return load_reference(tmp_path, NET)


def test_seeded_weights(toy):
    """He-normal by fan-out, from one draw in the network's state-dict order;
    the residual branch's last BatchNorm at ``residual_bn_weight`` on
    exactly the keys the module declares; every other BatchNorm the identity."""
    sd = make_state_dict(toy, NET, 17, "cpu", torch.float32, residual_bn_weight=0.25)
    shapes = state_shapes(toy, NET)
    assert sd.keys() == shapes.keys() and all(sd[k].shape == s for k, s in shapes.items())
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    assert kernels == ["stem.conv.weight", "block.depthwise_cnn.conv.weight",
                       "block.pointwise_cnn.conv.weight", "head.conv.weight"]
    draw = torch.randn(sum(shapes[k].numel() for k in kernels),
                       generator=torch.Generator().manual_seed(17))
    at = 0
    for k in kernels:
        cout, _, kh, kw = shapes[k]
        n = shapes[k].numel()
        want = draw[at:at + n].view(shapes[k]) * (2.0 / (cout * kh * kw)) ** 0.5
        assert torch.allclose(sd[k], want, rtol=1e-6, atol=0), k
        at += n
    bn_weights = {k for k, s in shapes.items() if k.endswith("bn.weight")}
    assert bn_weights == {"stem.bn.weight", "block.depthwise_cnn.bn.weight",
                          "block.pointwise_cnn.bn.weight"}
    assert toy.residual_bn_weights(NET, shapes) == {"block.pointwise_cnn.bn.weight"}
    for k in bn_weights:
        want = 0.25 if k == "block.pointwise_cnn.bn.weight" else 1.0
        assert torch.equal(sd[k], torch.full(shapes[k], want)), k
    assert torch.equal(sd["head.conv.bias"], torch.zeros(5))


def test_centred_classifier(toy):
    """Only the module's own classifier bias moves, to minus each class's
    mean logit: the centred network's mean logits are 0."""
    sd = make_state_dict(toy, NET, 18, "cpu", torch.float32)
    image = torch.randn((1, 3, 24, 32), generator=torch.Generator().manual_seed(1))
    out = center_classifier(toy, NET, sd, image)
    assert [k for k in sd if not torch.equal(sd[k], out[k])] == ["head.conv.bias"]
    with torch.no_grad():
        logits = reference_network(toy, NET, out, "cpu")(image)
    assert logits.shape == (1, 5, 12, 16)
    assert float(logits.mean(dim=(0, 2, 3)).abs().max()) < 1e-5


def test_reference_network_loads_strictly(toy):
    sd = make_state_dict(toy, NET, 19, "cpu", torch.bfloat16)
    model = reference_network(toy, NET, sd, "cpu", training=True)
    assert model.training and all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.equal(model.state_dict()["stem.conv.weight"], sd["stem.conv.weight"].float())
    with pytest.raises(RuntimeError, match="Unexpected key"):
        reference_network(toy, NET, dict(sd, extra=torch.zeros(1)), "cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        reference_network(toy, NET, {k: v for k, v in sd.items() if k != "head.conv.bias"},
                          "cpu")


@pytest.mark.parametrize("hw", [(24, 32), (65, 97)])
def test_forward_flops_by_hand(toy, hw):
    """Stem 3x3 (3 -> 8), depthwise 3x3 (8 groups), pointwise 8 -> 8 and the
    classifier 8 -> 5, each at half the input (the average pool)."""
    h, w = hw[0] // 2, hw[1] // 2
    c, k = NET["channels"], NET["num_classes"]
    by_hand = 2 * h * w * (3 * c * 9 + 1 * c * 9 + c * c + c * k)
    assert forward_flops(toy, NET, *hw) == by_hand


def test_deeplab_takes_a_backbone():
    """``DeepLabV3Plus`` around a backbone the caller hands it: the head's
    state-dict keys stay those of the ResNet network, and the forward runs
    the given backbone (2048 channels at 1/16, 256 at 1/4)."""
    import torch.nn as nn
    import torch.nn.functional as F

    class Strided(nn.Module):
        def __init__(self):
            super().__init__()
            self.low = deeplab.ConvBNReLU(3, 256, 1)
            self.high = deeplab.ConvBNReLU(256, 2048, 1)

        def forward(self, x):
            low = self.low(F.avg_pool2d(x, 4))
            return {"feature": self.high(F.avg_pool2d(low, 4)), "low_feature": low}

    net = json.loads((REPO / "benchmark/configs/deeplabv3p-rx50-os16-train.json").read_text())
    net = net["network"]
    with torch.device("meta"):
        default = deeplab.network(net).state_dict()
        handed = deeplab.DeepLabV3Plus(net, Strided())
    head = lambda keys: {k for k in keys if not k.startswith("backbone.")}  # noqa: E731
    assert head(handed.state_dict()) == head(default)
    assert {k for k in handed.state_dict() if k.startswith("backbone.")} == {
        f"backbone.{m}.{p}" for m in ("low", "high")
        for p in ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var",
                  "bn.num_batches_tracked")}
    with torch.no_grad():
        logits = handed.eval()(torch.empty((1, 3, 64, 96), device="meta"))
    # the decoder's two unpadded 3x3 refine convs trim 4 pixels off 1/4
    assert logits.shape == (1, 19, 12, 20)


def _digest(state_dict) -> str:
    h = hashlib.sha256()
    for k, v in state_dict.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ``make_state_dict`` on the CPU's generator before the configuration named
# its reference network: each configuration at its published widths, in the
# type its driver makes the weights in, with its ``residual_bn_weight``
PINNED = {
    ("deeplabv3p-rx50-os8-serve", 7):
        "e7304fecce7584bf3541e8e0e61b46621253d4c4c57f7787f42bdbe48e4b553b",
    ("deeplabv3p-rx50-os8-serve", 2 ** 31 + 5):
        "29fd500da50ca4a71f7f7964c1ada41baadc308d0058962c52a2743327ac003c",
    ("deeplabv3p-rx50-os16-train", 7):
        "0e117531642741947b28dd5ae0c54726b49ad485d2859d326e94e2c1adaa46ef",
    ("deeplabv3p-rx50-os16-train", 2 ** 31 + 5):
        "b563e1afa01ad0dfdff4b07a5bf839cc8d994ebc484acff9d7abbbfffaf4d447",
}
DTYPE = {"deeplabv3p-rx50-os8-serve": torch.bfloat16,
         "deeplabv3p-rx50-os16-train": torch.float32}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_seeded_weights_pinned(name, seed):
    conf = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    reference = load_reference(REPO, conf["network"])
    assert reference.__file__ == deeplab.__file__
    sd = make_state_dict(reference, conf["network"], seed, "cpu", DTYPE[name],
                         conf["weights"]["residual_bn_weight"])
    assert _digest(sd) == PINNED[name, seed]
