"""Model FLOP utilisation of the fused frame step over the traced part:
the network's convolution FLOPs a frame (``counts/flops.py``, counted on
the configuration's reference network after the window) times the frames
traced, over the traced seconds, over the card's dense bf16 peak."""
from benchmark.core.readings import traced, traced_work
from benchmark.counts.flops import forward_flops
from benchmark.counts.kernels import H100_BF16_FLOPS


def read(run):
    frames = traced_work(run)
    if frames is None:
        return None
    c = run.config
    flops = forward_flops(run.reference, c["network"], c["input"]["height"],
                          c["input"]["width"])
    return 100.0 * flops * frames / traced(run).window_s / H100_BF16_FLOPS
