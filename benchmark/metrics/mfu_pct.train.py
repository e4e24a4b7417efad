"""Model FLOP utilisation of the training step over the traced steps:
three times the forward's convolution FLOPs an image (``counts/flops.py``,
counted on the configuration's reference network after the window) times
the images traced, over the traced seconds, over the card's dense bf16
peak."""
from benchmark.core.readings import traced, traced_work
from benchmark.counts.flops import train_step_flops
from benchmark.counts.kernels import H100_BF16_FLOPS


def read(run):
    images = traced_work(run)
    if images is None:
        return None
    crop = run.config["train"]["crop"]
    flops = train_step_flops(run.reference, run.config["network"], 1, crop, crop)
    return 100.0 * flops * images / traced(run).window_s / H100_BF16_FLOPS
