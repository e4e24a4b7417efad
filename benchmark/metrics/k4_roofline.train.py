"""K4 in the training step's forward against its byte roofline over the
traced steps: one launch an image on the (1, crop/16, crop/16, 2048) feature."""
from benchmark.core.readings import ITEMSIZE, kernel_roofline
from benchmark.counts.kernels import k4_bytes


def read(run):
    c = run.config
    net, side = c["network"], -(-c["train"]["crop"] // c["network"]["output_stride"])
    per = k4_bytes(1, side, side, 2048, len(net["aspp_dilations"]) - 1,
                   ITEMSIZE[c["train"]["compute_dtype"]])
    return kernel_roofline(run, "aspp_depthwise3x3_multi", per)
