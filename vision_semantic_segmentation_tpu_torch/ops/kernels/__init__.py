"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the repo.

==========  ==========================================  =====================
wrapper     replaces (JAX package)                      CUDA source
==========  ==========================================  =====================
K1 render   ops/pallas/render.py::render_bev_map_fused  csrc/render.cu
K2 fold     ops/pallas/fold.py::evidence_fold_add       csrc/fold.cu
K3 dw       ops/pallas/depthwise.py::depthwise3x3_dil.  csrc/depthwise.cu
K4 aspp     ops/pallas/depthwise.py::aspp_depthwise3x3  csrc/aspp_depthwise.cu
P1 hoisted  scripts/probe_depthwise_hoist.py::hoisted   csrc/depthwise_hoist.cu
P2 variant  scripts/probe_depthwise_hoist.py::hoisted_  csrc/depthwise_hoist.cu
==========  ==========================================  =====================

K3, P1 and P2 share one design, ``csrc/phase.cuh`` (a phase tile of a channel
group staged once in shared memory, walkers along its columns or rows), and
one launch plan, ``depthwise.depthwise_plan``; K4 is the same design for
several dilations at once, with ``depthwise.aspp_plan``.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises).
"""
from ._lib import CudaKernel, build_all, kernels, plain_versions, reset_launch_counts
from .depthwise import (
    aspp_depthwise3x3_multi,
    aspp_depthwise3x3_multi_plain,
    depthwise3x3_dilated,
    depthwise3x3_dilated_plain,
)
from .depthwise_hoist import hoisted, hoisted_plain, hoisted_variant
from .fold import evidence_fold_add_, evidence_fold_add_plain
from .render import (
    pack_colors,
    render_bev_map_fused,
    render_bev_map_plain,
    unpack_rgba_image,
)

__all__ = [
    "CudaKernel",
    "build_all",
    "kernels",
    "plain_versions",
    "reset_launch_counts",
    "aspp_depthwise3x3_multi",
    "aspp_depthwise3x3_multi_plain",
    "depthwise3x3_dilated",
    "depthwise3x3_dilated_plain",
    "evidence_fold_add_",
    "evidence_fold_add_plain",
    "hoisted",
    "hoisted_plain",
    "hoisted_variant",
    "pack_colors",
    "render_bev_map_fused",
    "render_bev_map_plain",
    "unpack_rgba_image",
]
