"""K2 (the evidence fold into the grid) against its byte roofline over the
traced part: one launch a frame on the whole (C, H, W) f32 grid."""
from benchmark.core.readings import kernel_roofline
from benchmark.counts.kernels import k2_bytes


def read(run):
    m = run.config["map"]
    (x0, x1), (y0, y1) = m["boundary"]
    h, w = int((x1 - x0) / m["resolution"]), int((y1 - y0) / m["resolution"])
    return kernel_roofline(run, "evidence_fold_add", k2_bytes(len(m["labels"]), h, w))
