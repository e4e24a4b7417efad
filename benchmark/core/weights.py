"""Network weights made from a seed, on the device, in a few large calls.

Every convolution kernel is He-normal with the fan-out convention (standard
deviation sqrt(2 / (out_channels * kh * kw))); convolution biases are 0;
BatchNorm is the identity (weight 1, bias 0, running mean 0, running
variance 1), but for the last BatchNorm of each residual branch, whose
weight is ``residual_bn_weight`` (1, or smaller as in the zero-init
residual recipe of Goyal et al., arXiv:1706.02677, which keeps a deep
network's training step well conditioned at initialisation).  The shapes,
the residual branches' last BatchNorm and the classifier's bias are the
configuration's reference module's (``benchmark/reference/__init__.py``).
All kernels come from one ``torch.randn`` call on a
``torch.Generator`` of the device, cut into views and scaled; the result is
cast once to the type the weights are served in.  The same dict goes to the
program and to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch


def state_shapes(reference, net: dict) -> Dict[str, torch.Size]:
    """Every state-dict entry's shape, from the network built on the meta device."""
    with torch.device("meta"):
        model = reference.network(net)
    return {k: v.shape for k, v in model.state_dict().items()}


def make_state_dict(reference, net: dict, seed: int, device, dtype: torch.dtype,
                    residual_bn_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    shapes = state_shapes(reference, net)
    residual_bn = reference.residual_bn_weights(net, shapes)
    dev = torch.device(device)
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) == 4]
    total = sum(shapes[k].numel() for k in kernels)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    std = torch.tensor([(2.0 / (shapes[k][0] * shapes[k][2] * shapes[k][3])) ** 0.5
                        for k in kernels], device=dev)
    counts = torch.tensor([shapes[k].numel() for k in kernels], device=dev)
    flat.mul_(torch.repeat_interleave(std, counts, output_size=total))
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for k in kernels:
        n = shapes[k].numel()
        out[k] = flat[at:at + n].view(shapes[k])
        at += n
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=dev)
        elif k in residual_bn:
            out[k] = torch.full(s, float(residual_bn_weight), device=dev)
        elif k.endswith("running_var") or (k.endswith("weight") and len(s) == 1):
            out[k] = torch.ones(s, device=dev)
        else:  # BatchNorm bias, running mean, convolution bias
            out[k] = torch.zeros(s, device=dev)
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in out.items()}


@torch.no_grad()
def center_classifier(reference, net: dict, state_dict: Dict[str, torch.Tensor],
                      image: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The classifier's biases set to minus each class's mean logit over one
    image, so that no class wins every pixel.

    A random network's features share a large common part, and with zero
    biases one class wins nearly every pixel (which one depends on the
    seed, so the map would get all or none of its evidence).  A trained
    classifier's biases balance its classes.  Only the last convolution's
    bias changes: BatchNorm statistics set from an image would make the
    random network chaotic (rounding grows block by block).  ``image``:
    (1, 3, H, W) normalised; the reference network runs it in float32.
    """
    with torch.device(image.device):
        model = reference.network(net)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in state_dict.items()})
    logits = model.eval()(image.float())
    key = reference.classifier_bias(net)
    out = dict(state_dict)
    out[key] = (state_dict[key].float() - logits.mean(dim=(0, 2, 3))).to(state_dict[key].dtype)
    return out
