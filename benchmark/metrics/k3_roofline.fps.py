"""K3 forward (the backbone's stride-1 depthwise 3x3 convs) against its byte
roofline over the traced part: the bytes of every K3 site of the
configuration's reference network (``counts/sites.py``, counted after the
window) times the frames traced, over the card's bandwidth, over the device
seconds of K3's CUDA kernels."""
from benchmark.core.readings import ITEMSIZE, KERNEL_SYMBOLS, traced, traced_work
from benchmark.counts.kernels import roofline_pct
from benchmark.counts.sites import k3_frame_bytes


def read(run):
    frames = traced_work(run)
    if frames is None:
        return None
    seconds, count = traced(run).kernel_seconds(KERNEL_SYMBOLS["depthwise3x3_dilated"])
    if not count or seconds <= 0:
        return None
    c = run.config
    net = c["network"]
    per = k3_frame_bytes(run.reference, net, c["input"]["height"], c["input"]["width"],
                         ITEMSIZE[net["compute_dtype"]])
    return roofline_pct(frames * per, seconds)
