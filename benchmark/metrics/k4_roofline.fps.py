"""K4 (ASPP's depthwise branches in one kernel) against its byte roofline
over the traced part: one launch a frame on the (1, H/OS, W/OS, 2048)
backbone feature."""
from benchmark.core.readings import ITEMSIZE, kernel_roofline
from benchmark.counts.kernels import k4_bytes


def read(run):
    c = run.config
    net, os_ = c["network"], c["network"]["output_stride"]
    h, w = -(-c["input"]["height"] // os_), -(-c["input"]["width"] // os_)
    per = k4_bytes(1, h, w, 2048, len(net["aspp_dilations"]) - 1, ITEMSIZE[net["compute_dtype"]])
    return kernel_roofline(run, "aspp_depthwise3x3_multi", per)
