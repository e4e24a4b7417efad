"""K3 as the depthwise branches' input gradient in the training step's
backward, against its byte roofline over the traced steps: one launch a
branch an image on the (1, crop/16, crop/16, 2048) gradient."""
from benchmark.core.readings import ITEMSIZE, kernel_roofline
from benchmark.counts.kernels import k3_bytes


def read(run):
    c = run.config
    side = -(-c["train"]["crop"] // c["network"]["output_stride"])
    return kernel_roofline(run, "depthwise3x3_dilated",
                           k3_bytes(1, side, side, 2048, ITEMSIZE[c["train"]["compute_dtype"]]))
