"""Comparisons of what a window produced with the plain reference.

Every function runs after the window, with the program's state freed; the
reference runs in float32 with TF32 off (``torch.backends``' switches), one
frame or one batch at a time.  Under ``control`` the reference computed one
precision lower is put in the program's place: the network with every
convolution's input and weight rounded to float8 e4m3 (the step below the
configured bfloat16), the map's arithmetic in bfloat16 (below float32).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..reference.deeplab import fp8_quant, normalize


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_network(reference, net: dict, state_dict: Dict[str, torch.Tensor], device,
                      training: bool = False) -> nn.Module:
    """The configuration's reference network (``reference.network``) in
    float32 on ``device``, loaded strictly from ``state_dict``."""
    tf32_off()
    with torch.device(device):
        model = reference.network(net)
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           if v.is_floating_point() else v for k, v in state_dict.items()},
                          strict=True)
    return model.train(training)


def logit_numbers(program: torch.Tensor, reference: torch.Tensor) -> Tuple[float, float]:
    """Two readings of one frame's (C, h, w) logits against the reference's:
    the largest absolute difference over the largest reference magnitude,
    and the widest gap by which the reference's logit of the program's
    label (its argmax) lies below the reference's best, over the standard
    deviation of the reference's logits."""
    p, r = program.float(), reference.float()
    err = float((p - r).abs().max() / r.abs().max().clamp_min(1e-30))
    label = p.argmax(0, keepdim=True)
    gap = (r.max(0, keepdim=True).values - r.gather(0, label)).max()
    return err, float(gap / r.std().clamp_min(1e-30))


@torch.no_grad()
def network_readings(reference, net: dict, state_dict, frames_u8: Sequence[torch.Tensor],
                     program_logits: Sequence[torch.Tensor], device,
                     control: bool, image_scale: float = 1.0) -> Tuple[float, float]:
    """Worst ``logit_numbers`` over the frames.  ``frames_u8``: (H, W, 3)
    uint8 frames as the window fed them; ``program_logits``: (1, C, h, w)
    logits the program produced for each (ignored under ``control``)."""
    model = reference_network(reference, net, state_dict, device)
    low = None
    if control:
        low = reference_network(reference, net, state_dict, device)
        low.set_quant(fp8_quant)
    errs, gaps = [], []
    for frame, logits in zip(frames_u8, program_logits):
        x = normalize(torch.as_tensor(frame, device=device)[None], image_scale)
        ref = model(x)[0]
        out = low(x)[0] if control else logits[0]
        e, g = logit_numbers(out, ref)
        errs.append(e)
        gaps.append(g)
    del model, low
    return max(errs), max(gaps)


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keep: List[str]) -> Tuple[float, str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger: the worst leaf's gap and name, and the median leaf's gap."""
    pn = {k: float(program[k].double().norm()) for k in keep}
    rn = {k: float(reference[k].double().norm()) for k in keep}
    med = sorted(rn.values())[len(rn) // 2]
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, sorted(gaps.values())[len(gaps) // 2]

