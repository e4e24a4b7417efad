"""The gradient of K3/K4: ``DepthwiseBranches`` against autograd.

On the CPU the Function runs its formulas on the plain versions: the
forward is K4's (K3's for one branch) plain version frame by frame, dx is
K3's plain version on the taps turned 180 degrees, one call per frame and
branch, summed over the branches in f32, and dW is the f32 shifted-product
sum.  Autograd of the plain twin (nine shifted multiply-adds) is the
reference.  The forward is equal bit for bit (the same function); dx and
dW agree to 1e-5 of the largest value (f32 sums taken in another order:
the flipped-tap walk sums dx's nine terms per branch, autograd scatters
them).  Shapes include d > W/2 and d > H and W (phases of one or two
pixels), and the channels-last layout the model feeds in.
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.models.layers import DepthwiseConv2d, depthwise_convs
from vision_semantic_segmentation_tpu_torch.ops.kernels.depthwise import (
    DepthwiseBranches,
    aspp_depthwise3x3_multi,
    depthwise3x3_dilated,
    depthwise_wgrad_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CASES = [
    # (batch, H, W, C), dilations
    ((2, 9, 11, 8), (1,)),
    ((2, 13, 13, 16), (6,)),
    ((3, 33, 33, 8), (6, 12, 18)),    # ASPP at OS16: d = 18 > W / 2
    ((2, 17, 19, 12), (1, 6, 18)),
    ((2, 20, 28, 4), (36,)),          # d > H and W: phases of one pixel
    ((1, 40, 44, 8), (6, 18, 36)),
]


def _inputs(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w9s = torch.from_numpy(rng.standard_normal((n, 9, shape[-1])).astype(np.float32))
    dys = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]
    return x, w9s, dys


def _reference(x, w9s, dils, dys):
    """Autograd of the plain twin, frame by frame as the wrappers run it."""
    x = x.clone().requires_grad_(True)
    w9s = w9s.clone().requires_grad_(True)
    c = x.shape[-1]
    outs = [[] for _ in dils]
    for i in range(x.shape[0]):
        kernels = [w9s[b].reshape(3, 3, 1, c) for b in range(len(dils))]
        frame = x[i : i + 1]
        ys = ([depthwise3x3_dilated(frame, kernels[0], dils[0])] if len(dils) == 1
              else aspp_depthwise3x3_multi(frame, kernels, dils))
        for b, y in enumerate(ys):
            outs[b].append(y)
    ys = [torch.cat(o) for o in outs]
    torch.autograd.backward(ys, dys)
    return [y.detach() for y in ys], x.grad, w9s.grad


def _close(got, want):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape,dils", CASES)
def test_function_matches_autograd_of_twin(shape, dils):
    x, w9s, dys = _inputs(shape, len(dils))
    want_y, want_dx, want_dw = _reference(x, w9s, dils, dys)
    xg = x.clone().requires_grad_(True)
    wg = w9s.clone().requires_grad_(True)
    ys = DepthwiseBranches.apply(xg, wg, tuple(dils))
    for y, w in zip(ys, want_y):
        assert torch.equal(y, w)
    torch.autograd.backward(list(ys), dys)
    _close(xg.grad, want_dx)
    _close(wg.grad, want_dw)


def test_dgrad_is_the_flipped_depthwise():
    """dx of one branch is the same depthwise with the taps turned 180
    degrees (stride 1, pad d on every side), exactly on one frame."""
    x, w9s, (dy,) = _inputs((1, 15, 17, 8), 1, seed=3)
    xg = x.clone().requires_grad_(True)
    (y,) = DepthwiseBranches.apply(xg, w9s, (5,))
    y.backward(dy)
    flipped = w9s[0].flip(0).reshape(3, 3, 1, 8)
    assert torch.equal(xg.grad, depthwise3x3_dilated(dy, flipped, 5))


def test_wgrad_plain_matches_conv_weight_grad():
    """The f32 wgrad against PyTorch's own conv weight gradient."""
    x, _, (dy,) = _inputs((2, 12, 14, 6), 1, seed=4)
    d = 3
    got = depthwise_wgrad_plain(x, dy, d)  # (9, C)
    want = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (6, 1, 3, 3), dy.permute(0, 3, 1, 2),
                                       padding=d, dilation=d, groups=6)  # (C, 1, 3, 3)
    _close(got, want.reshape(6, 9).t())


def test_layer_forward_equals_the_wrappers():
    """``depthwise_convs`` (the model's route, through ``DepthwiseBranches``
    over the batch) gives the public wrappers' outputs frame by frame, bit
    for bit, for one branch (K3) and several (K4)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 8, 13, 11)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    for dils in ((3,), (1, 6, 18)):
        convs = [DepthwiseConv2d(8, 8, 3, padding=d, dilation=d, groups=8, bias=False)
                 for d in dils]
        with torch.no_grad():
            ys = depthwise_convs(convs, x)
            kernels = [c.weight.permute(2, 3, 1, 0) for c in convs]
            for i in range(x.shape[0]):
                frame = x[i : i + 1].permute(0, 2, 3, 1).contiguous()
                want = ([depthwise3x3_dilated(frame, kernels[0], dils[0])] if len(dils) == 1
                        else aspp_depthwise3x3_multi(frame, kernels, list(dils)))
                for y, w in zip(ys, want):
                    assert torch.equal(y[i : i + 1].permute(0, 2, 3, 1), w)


def test_layer_gradient_through_depthwise_convs():
    """The ASPP layer's route (channels-last NCHW, conv weights (C, 1, 3, 3),
    ``DepthwiseBranches`` with its own backward, as on the card) gives the
    gradients of ``F.conv2d(groups=C)`` on the CPU."""
    rng = np.random.default_rng(5)
    convs = [DepthwiseConv2d(8, 8, 3, padding=d, dilation=d, groups=8, bias=False)
             for d in (2, 4)]
    x = torch.from_numpy(rng.standard_normal((2, 8, 11, 13)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    ys = depthwise_convs(convs, x)
    loss = sum((y * (i + 1)).square().sum() for i, y in enumerate(ys))
    loss.backward()
    got = [x.grad.clone()] + [c.weight.grad.clone() for c in convs]
    x.grad = None
    for c in convs:
        c.weight.grad = None
    ys = [torch.nn.functional.conv2d(x, c.weight, padding=c.padding, dilation=c.dilation,
                                     groups=8) for c in convs]
    loss = sum((y * (i + 1)).square().sum() for i, y in enumerate(ys))
    loss.backward()
    want = [x.grad] + [c.weight.grad for c in convs]
    for g, w in zip(got, want):
        _close(g, w)
