"""K3 and K4: dilated depthwise 3x3 (stride 1, zero pad = dilation), NHWC.

K3 replaces the TPU kernel ``vision_semantic_segmentation_tpu/ops/pallas/
depthwise.py::depthwise3x3_dilated``; its CUDA source is
``csrc/depthwise.cu`` (the design is in ``csrc/phase.cuh``).  On the H100 it
is bound by bytes (read x once, write y once).  Each phase
``x[pr::d, pc::d]`` holds every tap its own pixels need, at +-1 phase pixel
whatever the dilation is, so a block stages one phase tile of a channel
group in shared memory with a zero border of one phase pixel, and walkers
go down its columns: each staged row is loaded once for the three outputs
that use it.  The sums are f32 in the TPU kernel's tap order, rounded once
to the input dtype.  :func:`depthwise_plan` sizes that launch (tile, row
pitch, channel group, threads, shared bytes) for K3 and for the
column-major kernels of ``depthwise_hoist.py``; :func:`launch_depthwise`
passes it to the kernel, and the CPU tests walk the same plan.

K4 replaces ``aspp_depthwise3x3_multi`` of the same TPU module; its CUDA
source is ``csrc/aspp_depthwise.cu``.  It computes every ASPP atrous branch
from one read of the input, each branch equal to K3 bit for bit, and is
bound by bytes (one read, one write per branch).  With g the gcd of the
dilations, each phase ``x[pr::g, pc::g]`` holds every tap its own pixels
need (branch b's taps sit at +-d_b / g phase pixels), so one block stages a
phase's tile of one channel group in shared memory once and computes all
branches from it.  :func:`aspp_plan` sizes that launch (tile, halo, channel
group, threads, shared bytes); the wrapper passes it to the kernel, and the
CPU tests walk the same plan.

Gradient: :class:`DepthwiseBranches` is the ``torch.autograd.Function`` of
one or several branches over a batch of frames (the TPU kernels had no
backward; the JAX package trains through its shifted XLA depthwise).  Its
forward runs K4 per frame (K3 for one branch).  Stride is 1 and the zero
padding is d on every side, so dgrad is the same depthwise with the taps
turned 180 degrees: ``dx = sum_b K3(dy_b, flip(w_b), d_b)``, one K3 launch
per frame and branch, summed in f32.  wgrad, ``dW_b[t, c] = sum_{n,h,w}
dy_b * x shifted by tap t``, is plain f32 tensor code in this port
(:func:`depthwise_wgrad_plain`).  Every step picks kernel or plain version
by the tensor's device, as the wrappers do, so on the CPU the Function runs
its formulas on the plain versions.

Operators: K3 and K4 launch through the ``torch.library`` operators
``vss_torch::depthwise3x3`` ((1, H, W, C) -> (1, H, W, C)) and
``vss_torch::aspp_depthwise3x3_multi`` ((1, H, W, C) -> (n, H, W, C), the
branches stacked).  Their CUDA impls launch the kernels and count the
launches, their CPU impls are the plain versions, and their fake impls give
the outputs' shapes and (contiguous) strides, so ``torch.export`` keeps each
launch as one node of an exported graph.  Under ``no_grad``,
``models/layers.py::depthwise_convs`` calls them frame by frame
(:func:`depthwise_branches`) without :class:`DepthwiseBranches`; a call
that needs a gradient goes through the Function on the card, and on the CPU
through autograd of the plain version.

Note on bf16: the JAX package's default depthwise path (the shifted form,
``models/layers.py::ShiftedDepthwiseConv``) accumulates in the compute
dtype; the port follows the TPU kernel and accumulates in f32, so in bf16
the two differ by bf16 rounding of the partial sums.  In f32 they agree.
"""
from __future__ import annotations

import ctypes
import math
from functools import reduce
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._lib import OPS, CudaKernel, ptr, uses_plain

# K3's C signature, shared by the column-major kernels of depthwise_hoist.py:
# x, w, y, H, W, C, dilation, dtype, plan, stream
DEPTHWISE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p]
KERNEL = CudaKernel("depthwise3x3_dilated", "depthwise.cu", "depthwise3x3_dilated",
                    DEPTHWISE_ARGTYPES)
MULTI_KERNEL = CudaKernel(
    "aspp_depthwise3x3_multi", "aspp_depthwise.cu", "aspp_depthwise3x3_multi",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
)
MAX_BRANCHES = 8  # the CUDA source's kMaxBranches
SMEM_LIMIT = 232448  # a block's shared memory on the H100 (227 KB), csrc kMaxSmem
# K4's channels per block, in bytes of the input, and threads per block (at
# most; a multiple of the walker slots per pixel): the fastest pair of
# chip_smoke.py --sweep at the main path's shape
GROUP_BYTES = 64
THREADS = 128
# K3's and the column-major kernels' launch, from chip_smoke.py --sweep at
# the main path's shape: threads per block; the least channel group in bytes
# of the input, doubled while the staged tile stays within WALK_TILE_BYTES
# (five blocks fit an SM, so one block's staging overlaps another's walk);
# and the shared bytes above which a phase is cut into sub-tiles
WALK_THREADS = 128
WALK_GROUP_BYTES = 64
WALK_TILE_BYTES = 44 * 1024
WALK_SMEM_BUDGET = 64 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class AsppPlan(NamedTuple):
    """K4's launch: one block per (phase, phase sub-tile, channel group)."""

    g: int  # phase lattice step, the gcd of the dilations
    steps: Tuple[int, ...]  # each branch's tap offset in phase pixels, d / g
    tile_h: int  # output sub-tile of a phase, in phase pixels
    tile_w: int
    halo: int  # staged halo around the sub-tile (max(steps) unless cut to fit)
    group: int  # channels per block
    vector: int  # channels per walker: 4 (16-byte staging copies) or 1 (the scalar path)
    threads: int
    smem: int  # shared bytes: the staged tile, then the group's weights

    def c_args(self):
        """The int[8] the C entry point takes."""
        return (ctypes.c_int * 8)(self.g, self.tile_h, self.tile_w, self.halo, self.group,
                                  self.threads, self.smem, int(self.vector > 1))


def aspp_plan(
    h: int, w: int, c: int, dilations: Sequence[int], itemsize: int, aligned: bool = True,
    smem_budget: int = SMEM_LIMIT, group_bytes: int = GROUP_BYTES, threads: int = THREADS,
) -> AsppPlan:
    """K4's launch plan for a (1, h, w, c) input of ``itemsize`` bytes.

    A block stages its tile with a zero border of ``halo`` phase pixels,
    then the channel group's f32 weights.  The whole largest phase
    (ceil(h / g) x ceil(w / g) pixels) is one tile when that fits
    ``smem_budget``.  Otherwise the tile's larger side halves until it fits
    with a halo of max(d) / g; a tile no larger than its halo cuts the halo
    instead, and taps beyond a cut halo are read from device memory.
    ``aligned``: whether the input pointer is 16-byte aligned (the vector
    path needs it, and c a multiple of 16 bytes).
    """
    if not dilations or min(dilations) < 1:
        raise ValueError(f"dilations {tuple(dilations)}")
    g = reduce(math.gcd, dilations)
    steps = tuple(d // g for d in dilations)
    chunk = 16 // itemsize  # channels per 16-byte staging copy
    unit = chunk if aligned and c % chunk == 0 else 1
    vector = 4 if unit > 1 else 1
    group = max(unit, min(group_bytes // itemsize, -(-c // unit) * unit))
    slots = group // vector
    threads = max(slots, threads // slots * slots)
    ph, pw = -(-h // g), -(-w // g)
    weights = len(dilations) * 9 * group * 4  # the group's f32 weights, staged after the tile

    def smem(th: int, tw: int, halo: int) -> int:  # the tile with its (zero) border
        tile = (th + 2 * halo) * (tw + 2 * halo) * group * itemsize
        return -(-tile // 16) * 16 + weights

    th, tw, halo = ph, pw, max(steps)
    while smem(th, tw, halo) > smem_budget:
        if max(th, tw) > max(halo, 1):
            th, tw = (-(-th // 2), tw) if th >= tw else (th, -(-tw // 2))
        elif halo > 0:
            halo -= 1
        else:
            raise ValueError(f"{group} channels of one pixel exceed {smem_budget} bytes")
    return AsppPlan(g, steps, th, tw, halo, group, vector, threads, smem(th, tw, halo))


class DepthwisePlan(NamedTuple):
    """One dilation's launch: one block per (phase, phase sub-tile, channel group)."""

    tile_h: int  # output sub-tile of a phase, in phase pixels
    tile_w: int
    pitch: int  # staged elements per tile row, at least (tile_w + 2) * group
    group: int  # channels per block
    vector: int  # channels per walker: 4 (16-byte staging copies) or 1 (the scalar path)
    threads: int
    smem: int  # shared bytes: the staged tile with its one-pixel border

    def c_args(self):
        """The int[7] the C entry points take."""
        return (ctypes.c_int * 7)(self.tile_h, self.tile_w, self.pitch, self.group,
                                  self.threads, self.smem, int(self.vector > 1))


def depthwise_plan(
    h: int, w: int, c: int, dilation: int, itemsize: int, staged_itemsize: Optional[int] = None,
    aligned: bool = True, smem_budget: int = WALK_SMEM_BUDGET,
    group_bytes: Optional[int] = None, threads: int = WALK_THREADS,
) -> DepthwisePlan:
    """The launch plan of K3 and of the kernels of ``depthwise_hoist.py`` for
    a (1, h, w, c) input of ``itemsize`` bytes.

    A block stages a tile of one phase (ceil(h / d) x ceil(w / d) pixels at
    most) with a border of one phase pixel, ``staged_itemsize`` bytes an
    element (the input's, or 4 for a tile held as f32).  A walker takes 4
    channels (1 on the scalar path) of one line of the tile.

    The channel group (``group_bytes`` of the input, when given) is
    ``WALK_GROUP_BYTES``, doubled while the whole phase with its border
    stays within ``WALK_TILE_BYTES``: small phases (large dilations) take
    wide groups, so that a block has bytes in flight and walks for its
    threads.  The tile is the whole phase when that fits ``smem_budget``;
    otherwise its larger side halves until it does, and a sub-tile's border
    holds its neighbours' pixels.  ``aligned``: whether the input, weight
    and output pointers are 16-byte aligned (the vector path needs it, and
    c a multiple of 16 bytes).
    """
    if dilation < 1:
        raise ValueError(f"dilation {dilation} < 1")
    staged = staged_itemsize or itemsize
    chunk = 16 // itemsize  # channels per 16-byte staging copy
    unit = chunk if aligned and c % chunk == 0 else 1
    vector = 4 if unit > 1 else 1
    th, tw = -(-h // dilation), -(-w // dilation)

    def pitch(tw: int, group: int) -> int:
        """Elements per staged row.  Where a pixel's group is narrower than
        128 bytes, rows are padded to start 128-byte-disjoint: the walkers
        of neighbouring rows then read different banks."""
        row, pixel = (tw + 2) * group * staged, group * staged
        if pixel < 128:
            row += (pixel - row) % 128
        return row // staged

    def smem(th: int, tw: int, group: int) -> int:
        return -(-(th + 2) * pitch(tw, group) * staged // 16) * 16

    if group_bytes is None:
        group_bytes = WALK_GROUP_BYTES
        while smem(th, tw, 2 * group_bytes // itemsize) <= WALK_TILE_BYTES:
            group_bytes *= 2
    group = max(unit, min(group_bytes // itemsize, threads * vector, -(-c // unit) * unit))
    slots = group // vector
    threads = max(slots, threads // slots * slots)
    while smem(th, tw, group) > smem_budget:
        if max(th, tw) == 1:
            raise ValueError(f"{group} channels of one pixel exceed {smem_budget} bytes")
        th, tw = (-(-th // 2), tw) if th >= tw else (th, -(-tw // 2))
    return DepthwisePlan(th, tw, pitch(tw, group), group, vector, threads, smem(th, tw, group))


def pointers_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (the vector path)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"single-frame NHWC expected, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")


def _weights9(kernel: torch.Tensor, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """(3, 3, 1, C) depthwise weights -> (9, C) f32 on x's device (tap-major)."""
    c = x.shape[-1]
    if kernel.shape != (3, 3, 1, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match C={c}")
    if dilation < 1:
        raise ValueError(f"dilation {dilation} < 1")
    return kernel.reshape(9, c).to(device=x.device, dtype=torch.float32).contiguous()


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the sums are taken in: f32, or f64 for an f64 ``x`` (which
    only the plain versions take)."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise3x3_dilated_plain(x: torch.Tensor, w9: torch.Tensor, dilation: int) -> torch.Tensor:
    """Plain PyTorch version: nine shifted multiply-adds in f32, row-major taps.

    ``x`` is (1, H, W, C); ``w9`` is (9, C) f32 (tap-major).  An f64 ``x``
    (with f64 weights) is summed in f64.
    """
    d = dilation
    _, h, w, _ = x.shape
    xp = F.pad(x[0].to(_sum_dtype(x)), (0, 0, d, d, d, d))
    acc = None
    for ti in range(3):
        for tj in range(3):
            term = xp[ti * d : ti * d + h, tj * d : tj * d + w] * w9[ti * 3 + tj]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)[None]


def depthwise3x3_dilated(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """Depthwise 3x3, stride 1, pad = dilation (same-size output).

    Args:
        x: (1, H, W, C) feature map, float32 or bfloat16.  A channels-last
            NCHW activation permuted to NHWC is already contiguous.
        kernel: (3, 3, 1, C) depthwise weights (the JAX package's layout).
        dilation: atrous rate (also the per-side zero padding).
    Returns:
        (1, H, W, C) in x's dtype; the caller adds any bias.  On the card the
        result carries :class:`DepthwiseBranches`'s gradient where x or the
        kernel needs one; on the CPU, autograd of the plain version.
    """
    _check_input(x)
    w9 = _weights9(kernel, x, dilation)
    if grad_through_kernels(x, [w9], 1):
        return DepthwiseBranches.apply(x, w9[None], (dilation,))[0]
    return _k3(x, w9, dilation)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _k3(x: torch.Tensor, w9: torch.Tensor, dilation: int) -> torch.Tensor:
    """K3 (its op) on one frame, outside ``DepthwiseBranches``.  On the CPU a
    call that needs a gradient runs the plain version itself, so autograd
    sees its graph."""
    if uses_plain(KERNEL, x) and _needs_grad(x, w9):
        return depthwise3x3_dilated_plain(x, w9, dilation)
    return torch.ops.vss_torch.depthwise3x3(x.contiguous(), w9, int(dilation))


def _k4(x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int]) -> List[torch.Tensor]:
    """K4 (its op) on one frame, outside ``DepthwiseBranches``; the CPU's
    gradient route as :func:`_k3`'s."""
    if uses_plain(MULTI_KERNEL, x) and _needs_grad(x, w9s):
        return aspp_depthwise3x3_multi_plain(x, w9s, dilations)
    y = torch.ops.vss_torch.aspp_depthwise3x3_multi(x.contiguous(), w9s,
                                                     [int(d) for d in dilations])
    return [y[b : b + 1] for b in range(len(dilations))]


def _k3_cuda(x: torch.Tensor, w9: torch.Tensor, dilation: int) -> torch.Tensor:
    if KERNEL.plain_on_cuda:
        return depthwise3x3_dilated_plain(x, w9, dilation)
    _, h, w, c = x.shape
    plan = depthwise_plan(h, w, c, dilation, x.element_size(), aligned=pointers_aligned(x, w9))
    return launch_depthwise(KERNEL, x, w9, dilation, plan)


def _k4_cuda(x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    if MULTI_KERNEL.plain_on_cuda:
        return torch.cat(aspp_depthwise3x3_multi_plain(x, w9s, dilations))
    _, h, w, c = x.shape
    plan = aspp_plan(h, w, c, dilations, x.element_size(), aligned=x.data_ptr() % 16 == 0)
    return _launch_multi(x, w9s, dilations, plan)


def _k4_cpu(x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    return torch.cat(aspp_depthwise3x3_multi_plain(x, w9s, dilations))


OPS.define("depthwise3x3(Tensor x, Tensor w9, int dilation) -> Tensor")
OPS.impl("depthwise3x3", _k3_cuda, "CUDA")
OPS.impl("depthwise3x3", depthwise3x3_dilated_plain, "CPU")
OPS.define("aspp_depthwise3x3_multi(Tensor x, Tensor w9s, int[] dilations) -> Tensor")
OPS.impl("aspp_depthwise3x3_multi", _k4_cuda, "CUDA")
OPS.impl("aspp_depthwise3x3_multi", _k4_cpu, "CPU")


@torch.library.register_fake("vss_torch::depthwise3x3", lib=OPS)
def _k3_fake(x, w9, dilation):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.register_fake("vss_torch::aspp_depthwise3x3_multi", lib=OPS)
def _k4_fake(x, w9s, dilations):
    return x.new_empty((len(dilations), *x.shape[1:]))


def depthwise_branches(x: torch.Tensor, w9s: torch.Tensor,
                       dilations: Sequence[int]) -> List[torch.Tensor]:
    """``y_b = depthwise3x3(x, w_b, d_b)`` for a batch, frame by frame (K3
    for one branch, K4 for several), outside autograd: the forward of
    :class:`DepthwiseBranches`, and what a ``no_grad`` caller runs."""
    if x.ndim != 4 or not x.dtype.is_floating_point:
        raise ValueError(f"NHWC float batch expected, got {tuple(x.shape)} {x.dtype}")
    n = len(dilations)
    if not 1 <= n <= MAX_BRANCHES or w9s.shape != (n, 9, x.shape[-1]):
        raise ValueError(f"weights {tuple(w9s.shape)} for {n} dilations of C={x.shape[-1]}")
    w9s = w9s.to(_sum_dtype(x)).contiguous()
    outs = [[] for _ in dilations]
    for i in range(x.shape[0]):
        frame = x[i : i + 1]
        ys = [_k3(frame, w9s[0], dilations[0])] if n == 1 else _k4(frame, w9s, dilations)
        for b, y in enumerate(ys):
            outs[b].append(y)
    return [o[0] if len(o) == 1 else torch.cat(o) for o in outs]


def launch_depthwise(
    kernel: CudaKernel, x: torch.Tensor, w9: torch.Tensor, dilation: int, plan: DepthwisePlan
) -> torch.Tensor:
    """Launch K3 or a column-major kernel on a contiguous CUDA ``x`` and
    (9, C) f32 ``w9`` with a given plan (the wrapper's, or one with another
    budget, channel group or thread count; the kernel refuses a plan that
    does not match the shapes)."""
    _check_input(x)
    _, h, w, c = x.shape
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"{kernel.name} needs a contiguous NHWC input on the card")
    if (w9.shape != (9, c) or w9.dtype != torch.float32 or w9.device != x.device
            or not w9.is_contiguous()):
        raise ValueError(f"weights {tuple(w9.shape)} {w9.dtype} for C={c}")
    y = torch.empty_like(x)
    args = plan.c_args()
    kernel.launch(ptr(x), ptr(w9), ptr(y), h, w, c, dilation, _DTYPES[x.dtype],
                  ctypes.cast(args, ctypes.c_void_p))
    return y


def aspp_depthwise3x3_multi_plain(
    x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int]
) -> List[torch.Tensor]:
    """Plain PyTorch version: K3's plain version per branch, in branch order.

    ``w9s`` is (n, 9, C) f32 (tap-major per branch).
    """
    return [depthwise3x3_dilated_plain(x, w9s[b], d) for b, d in enumerate(dilations)]


def aspp_depthwise3x3_multi(
    x: torch.Tensor, kernels: Sequence[torch.Tensor], dilations: Sequence[int]
) -> List[torch.Tensor]:
    """Every ASPP atrous depthwise branch from one pass over ``x``.

    Equal to ``[depthwise3x3_dilated(x, k, d) for k, d in zip(kernels,
    dilations)]``, bit for bit.

    Args:
        x: (1, H, W, C) feature map, float32 or bfloat16.
        kernels: one (3, 3, 1, C) depthwise kernel per branch (at most 8).
        dilations: one atrous rate per branch (also its zero padding).
    Returns:
        A list of (1, H, W, C) outputs in x's dtype, one per branch, with
        :class:`DepthwiseBranches`'s gradient on the card.
    """
    _check_input(x)
    n = len(dilations)
    if not 1 <= n <= MAX_BRANCHES or len(kernels) != n:
        raise ValueError(f"{len(kernels)} kernels for {n} dilations (1..{MAX_BRANCHES})")
    w9s = torch.stack([_weights9(k, x, d) for k, d in zip(kernels, dilations)])
    if grad_through_kernels(x, [w9s], n):
        return list(DepthwiseBranches.apply(x, w9s, tuple(dilations)))
    return _k4(x, w9s, dilations)


def launch_multi(
    x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int], plan: AsppPlan
) -> List[torch.Tensor]:
    """Launch K4 on a contiguous CUDA ``x`` and (n, 9, C) f32 ``w9s`` with a
    given plan (the wrapper's, or one with another budget or channel group;
    the kernel refuses a plan that does not match the shapes)."""
    return list(_launch_multi(x, w9s, dilations, plan).split(1))


def _launch_multi(x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int],
                  plan: AsppPlan) -> torch.Tensor:
    """K4's launch; the branches stacked, (n, H, W, C)."""
    _check_input(x)
    _, h, w, c = x.shape
    n = len(dilations)
    if not 1 <= n <= MAX_BRANCHES:
        raise ValueError(f"{n} dilations (1..{MAX_BRANCHES})")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("aspp_depthwise3x3_multi needs a contiguous NHWC input on the card")
    if (w9s.shape != (n, 9, c) or w9s.dtype != torch.float32 or w9s.device != x.device
            or not w9s.is_contiguous()):
        raise ValueError(f"weights {tuple(w9s.shape)} {w9s.dtype} for {n} branches of C={c}")
    y = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    dil = (ctypes.c_int * MAX_BRANCHES)(*[int(d) for d in dilations])
    args = plan.c_args()
    MULTI_KERNEL.launch(ptr(x), ptr(w9s), ptr(y), h, w, c, n, ctypes.cast(dil, ctypes.c_void_p),
                        _DTYPES[x.dtype], ctypes.cast(args, ctypes.c_void_p))
    return y


def depthwise_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, dilation: int) -> torch.Tensor:
    """wgrad of one branch over a batch: ``dW[t, c] = sum_{n,h,w} dy * x``
    shifted by tap t, in f32 (f64 for an f64 ``x``).  ``x`` and ``dy`` are
    (B, H, W, C); returns (9, C), tap-major."""
    d = dilation
    _, h, w, _ = x.shape
    xp = F.pad(x.to(_sum_dtype(x)), (0, 0, d, d, d, d))
    dyf = dy.to(xp.dtype)
    return torch.stack([
        (xp[:, ti * d : ti * d + h, tj * d : tj * d + w] * dyf).sum((0, 1, 2))
        for ti in range(3) for tj in range(3)
    ])


def grad_through_kernels(x: torch.Tensor, weights: Sequence[torch.Tensor], branches: int) -> bool:
    """Whether a depthwise call on ``x`` takes :class:`DepthwiseBranches`:
    on the kernel route (a CUDA tensor), where x or a weight needs a gradient."""
    kernel = KERNEL if branches == 1 else MULTI_KERNEL
    return (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights))
            and not uses_plain(kernel, x))


class DepthwiseBranches(torch.autograd.Function):
    """``y_b = depthwise3x3(x, w_b, d_b)`` for every branch b, frame by frame.

    ``apply(x, w9s, dilations)``: x (B, H, W, C) f32 or bf16, w9s (n, 9, C)
    f32 tap-major, n <= 8 dilations.  Returns n (B, H, W, C) tensors in x's
    dtype.  Forward: K4 per frame (K3 for n = 1).  Backward: dx by K3 on
    the flipped taps, one launch per frame and branch, summed over branches
    in f32 and rounded once to x's dtype; dW by
    :func:`depthwise_wgrad_plain`, f32.  On a CPU tensor every step runs
    the plain versions, which also take an f64 ``x`` and sum it in f64
    (the kernels refuse f64).
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w9s: torch.Tensor, dilations: Tuple[int, ...]):
        ys = depthwise_branches(x, w9s, dilations)
        ctx.save_for_backward(x, w9s.to(_sum_dtype(x)).contiguous())
        ctx.dilations = tuple(dilations)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        x, w9s = ctx.saved_tensors
        dilations = ctx.dilations
        dx = dw = None
        if ctx.needs_input_grad[0]:
            flipped = w9s.flip(1).contiguous()  # tap t -> 8 - t: the 180-degree turn
            dx = torch.empty_like(x, memory_format=torch.contiguous_format)
            for i in range(x.shape[0]):
                acc = None
                for b, d in enumerate(dilations):
                    term = _k3(dys[b][i : i + 1].to(x.dtype), flipped[b], d)
                    if len(dilations) > 1:
                        term = term.to(w9s.dtype)
                    acc = term if acc is None else acc + term
                dx[i : i + 1] = acc
        if ctx.needs_input_grad[1]:
            dw = torch.stack([depthwise_wgrad_plain(x, dy, d) for dy, d in zip(dys, dilations)])
        return dx, dw, None
