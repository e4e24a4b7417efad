"""Q1: int8 3x3 convolution with the requantize epilogue.

A port-only kernel (``csrc/int8_conv.cu``): the JAX package runs its int8
convs through XLA's ``conv_general_dilated`` with
``preferred_element_type=int32`` (``vision_semantic_segmentation_tpu/
models/quant.py:72-78`` and ``:385-392``), outside any Pallas kernel, and no
PyTorch call computes an int8 grouped, dilated, strided conv with int32
accumulation on CUDA.  It runs every 3x3 site of the int8 backbone
(``models/quant.py``): a bottleneck's grouped conv2, a BasicBlock's two.

Activations are channels last: ``x`` (N, H, W, Cin) int8, ``w`` (Cout, 3,
3, Cin / groups) int8, ``scale`` and ``shift`` (Cout,) f32.  The int32 sum
``acc`` then goes through :func:`epilogue` in the JAX package's order
(``quant.py:394-411``): ``acc * scale + shift`` in f32, then either rounded
half to even and clipped to ``[0 or -127, 127]`` as int8 (``scale`` =
total / out_scale, ``shift`` = bias / out_scale; ReLU folds into the clip),
or, ReLU optional, cast to f32 or bf16 (``scale`` = total, ``shift`` =
bias).  The plain version convolves the int8 values in f64, which is exact
(``|acc| <= 9 * 2048 * 127**2 < 2**53``), and runs the same epilogue; the
kernel equals it bit for bit.  Each wrapper runs the plain version for a
CPU tensor and launches the kernel for a CUDA tensor.

The kernel is an implicit GEMM on the int8 tensor cores (``mma.sync``
m16n8k32) for each K tile, one group or several narrow ones with
block-diagonal weights: M = output pixels, N = the tile's output channels,
K = 9 taps x its input channels in the weights' tap-major order.
:func:`q1_plan` sizes its launch (K tile, output tile, channel block, K
chunk, the staged tile's layout, shared bytes, grid) and :func:`launch_q1`
passes the plan to the kernel as ints; the CPU tests walk the same plan
block by block (``tests/test_torch_int8_plan.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, ptr, uses_plain

KERNEL = CudaKernel(
    "int8_conv3x3", "int8_conv.cu", "int8_conv3x3",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
)
_OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_ITEMSIZE = {torch.int8: 1, torch.float32: 4, torch.bfloat16: 2}
SMEM_LIMIT = 232448  # a block's shared memory on the H100 (227 KB), csrc kMaxSmem
# two blocks an SM: the SM's 228 KB less 1 KB a block, halved
SMEM_TARGET = (233472 - 2 * 1024) // 2
THREADS = 256  # a block's threads at most, csrc kMaxThreads
# the launch choices, from chip_smoke.py --sweep at the ResNeXt50 sites:
# output rows x columns of a tile (a multiple of 128 pixels, the largest
# warp task) and output channels of a block at most; a block takes a run
# of tiles (at most MAX_TILES_PER_BLOCK) where the grid would still fill
# the card's SMs (the wrapper reads their count) WAVES times over
TILE = (16, 16)
BLOCK_COLS = 64
WAVES = 2
MAX_TILES_PER_BLOCK = 4


class Q1Plan(NamedTuple):
    """Q1's launch: one block per (channel block, run of ``tpb`` output
    tiles).

    The kernel's groups are K tiles: ``gpt`` groups of 4 or 8 channels
    with block-diagonal weights (so that an A row is 16 bytes of one tap
    and an n8 tile holds real columns), else one group each.  A block
    covers ``gb`` whole K tiles, or one column slice of a K tile wider than
    the block.  It walks (tile, K chunk) items: per item (``ck`` input
    channels of each of its groups; K = 9 * ck tap-major, zero weights pad
    it to ``kpad``) it stages the input tile with its halo, and the chunk's
    weights, in shared memory by asynchronous copies, two stages deep (the
    next item's copies fly while this one multiplies; with one chunk the
    weights are staged once a block); then each warp task multiplies ``mt``
    m16 tiles of pixels by ``nt`` n8 tiles of one group's columns
    (``mma.sync`` m16n8k32 s8).  With several chunks each warp holds one
    task's sums across them.  The epilogue writes an output tile in shared
    memory, copied out in ``ovec``-byte stores.

    The staged tile's rows are either contiguous (input rows ``y * s + ky *
    d`` from the tile's origin) or three bands of ``tile_h`` rows, one per
    tap row, whichever is fewer; likewise its columns, whose contiguous form
    is split into ``stride`` phases so that neighbouring output pixels read
    neighbouring staged pixels.  Staged row ``r`` is input row ``(r % row_a)
    * row_s + (r // row_a) * row_d`` from the origin (column ``c`` likewise),
    and output ``(y, x)`` reads tap ``(ky, kx)`` at staged pixel ``(y *
    y_step + tap_row[ky], x + tap_col[kx])``.
    """

    gpt: int  # groups of a K tile (8 or 4 for 4 or 8 channels a group, else 1)
    ck: int  # input channels of a K tile in a K chunk (4, 8, 16 or 32)
    chunks: int  # K chunks, gpt * Cin / groups / ck
    nt: int  # n8 tiles of a warp task (1, 2 or 4)
    mt: int  # m16 tiles of a warp task, 8 / nt
    n: int  # images
    tile_h: int  # output rows of a tile
    tile_w: int  # output columns of a tile, a power of 2 from 16
    tw_shift: int  # log2(tile_w)
    tiles_h: int
    tiles_w: int
    tpb: int  # tiles of a block (consecutive, columns fastest)
    gb: int  # K tiles of a block
    slices: int  # column slices of a K tile
    cols: int  # output columns of a slice (the last slice may hold fewer)
    cols_p: int  # cols padded to a multiple of 8 * nt (zero weights)
    kpad: int  # 9 * ck padded to a multiple of 32 (zero weights)
    tasks: int  # warp tasks of a block
    threads: int
    srows: int  # staged rows
    row_a: int
    row_s: int
    row_d: int
    scols: int  # staged pixels of a staged row
    col_a: int
    col_s: int
    col_d: int
    y_step: int
    tap_row: Tuple[int, int, int]
    tap_col: Tuple[int, int, int]
    pitch: int  # bytes of a staged pixel (gb * ck, padded)
    vec: int  # bytes of one input copy (16, 8 or 4)
    wvec: int  # bytes of one weight copy (16, 8 or 4)
    wpitch: int  # bytes of a staged weight row (kpad, padded)
    opitch: int  # bytes of an output tile row
    ovec: int  # bytes of one output store (16, 8 or 4)
    in_stages: int  # input stages: 2, or 1 where a block has one item
    in_bytes: int  # one input stage
    w_bytes: int  # one weight stage (two with several chunks)
    w_off: int  # the weight stages' offset in shared memory
    o_off: int  # the output tile's offset
    map_off: int  # the staged rows' and columns' input offsets (int32)
    ss_off: int  # the block's scale and shift (f32, zero in padded columns)
    smem: int  # shared bytes of a block
    grid: int

    def c_args(self):
        """The int array the C entry point takes, field by field (one array a
        plan, kept for the process: the wrapper's launch costs no rebuild)."""
        return _c_args(self)


@functools.lru_cache(maxsize=512)
def _c_args(plan: Q1Plan):
    flat = []
    for v in plan:
        flat.extend(v if isinstance(v, tuple) else (v,))
    return (ctypes.c_int * len(flat))(*flat)


def _pitch(nbytes: int) -> int:
    """``nbytes`` padded to an odd multiple of 16: the 8 rows of a fragment
    load then start in 8 different groups of 4 banks."""
    p = -(-nbytes // 16) * 16
    return p + 16 if p % 32 == 0 else p


def _copy_bytes(*sizes: int) -> int:
    """The widest copy (16, 8 or 4 bytes) that divides every size."""
    return next(v for v in (16, 8, 4) if all(s % v == 0 for s in sizes))


def conv_out_hw(h: int, w: int, stride: int, padding: int, dilation: int) -> Tuple[int, int]:
    """Output size of a 3x3 conv."""
    return ((h + 2 * padding - 2 * dilation - 1) // stride + 1,
            (w + 2 * padding - 2 * dilation - 1) // stride + 1)


@functools.lru_cache(maxsize=512)
def q1_plan(n: int, h: int, w: int, cin: int, cout: int, groups: int, stride: int,
            padding: int, dilation: int, out_itemsize: int, tile: Tuple[int, int] = TILE,
            block_cols: int = BLOCK_COLS, tiles_per_block: Optional[int] = None,
            smem_budget: int = SMEM_LIMIT, sms: int = 132) -> Q1Plan:
    """Q1's launch plan for an (n, h, w, cin) input, (cout, 3, 3, cin /
    groups) weights and an output of ``out_itemsize`` bytes an element.

    Raises ``ValueError`` for what the kernel does not take (the wrapper's
    refusals) and where no plan fits ``smem_budget``.  ``tile`` (output
    rows, columns; a multiple of 128 pixels), ``block_cols`` and
    ``tiles_per_block`` (by default as many as keep ``WAVES`` blocks on each
    of the card's ``sms`` SMs, the H100's 132 unless the caller reads the
    card's own; at most ``MAX_TILES_PER_BLOCK``) are the launch choices.
    Where a block's shared memory exceeds ``SMEM_TARGET`` (two blocks an SM) or
    ``smem_budget``, a block takes fewer K tiles, then fewer columns of its
    K tile, then fewer rows; where a chunked K has more tasks than warps,
    fewer rows come before fewer columns.  Above the target it still
    launches within ``smem_budget``.
    """
    if groups < 1 or cin % groups or cout % groups:
        raise ValueError(f"groups {groups} do not divide Cin {cin} and Cout {cout}")
    cin_g, cout_g = cin // groups, cout // groups
    if cin_g % 4 or cout_g % 4:
        raise ValueError(f"int8_conv3x3 needs Cin / groups and Cout / groups multiples of 4, "
                         f"got {cin_g} and {cout_g}")
    if stride < 1 or dilation < 1 or padding < 0 or n < 1:
        raise ValueError(f"stride {stride}, dilation {dilation}, padding {padding}, batch {n}")
    ho, wo = conv_out_hw(h, w, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for a {h}x{w} input")
    if out_itemsize not in (1, 2, 4):
        raise ValueError(f"out_itemsize {out_itemsize}")
    tile_h, tile_w = tile
    if tile_h < 1 or tile_w < 16 or tile_w & (tile_w - 1) or tile_h * tile_w % 128:
        raise ValueError(f"tile {tile}: columns a power of 2 from 16, a multiple of 128 pixels")
    # narrow groups (4 or 8 channels in, at most 8 out) multiply as K tiles
    # of gpt groups, 32 channels, with block-diagonal weights: whole
    # ldmatrix rows and n8 tiles, for gpt times the products
    gpt = 32 // cin_g if cin_g in (4, 8) and cout_g <= 8 and groups % (32 // cin_g) == 0 else 1
    groups_k, cin_k, cout_k = groups // gpt, cin_g * gpt, cout_g * gpt
    ck = next(c for c in (32, 16, 8, 4) if cin_k % c == 0)
    chunks = cin_k // ck
    wvec = _copy_bytes(ck // gpt)
    kpad = -(-9 * ck // 32) * 32
    nt = 1 if cout_k <= 8 else 2 if cout_k <= 16 else 4
    mt = 8 // nt
    if cout_k <= 8 * nt:  # whole K tiles a block
        cols = cout_k
        gb = max(d for d in range(1, groups_k + 1)
                 if groups_k % d == 0 and d * cout_k <= max(block_cols, cout_k))
    else:  # column slices of one K tile
        gb, cols = 1, min(cout_k, max(32, block_cols // 32 * 32))

    w_stages = 2 if chunks > 1 else 1
    wpitch = _pitch(kpad)
    while True:
        pixels = tile_h * tile_w
        # rows: contiguous, or three bands of tile_h rows
        rows_c = (tile_h - 1) * stride + 2 * dilation + 1
        if rows_c <= 3 * tile_h:
            srows, row_a, row_s, row_d, y_step = rows_c, rows_c, 1, 0, stride
            tap_row = (0, dilation, 2 * dilation)
        else:
            srows, row_a, row_s, row_d, y_step = 3 * tile_h, tile_h, stride, dilation, 1
            tap_row = (0, tile_h, 2 * tile_h)
        # columns: contiguous in stride phases, or three bands of tile_w
        per_phase = -(-((tile_w - 1) * stride + 2 * dilation + 1) // stride)
        if stride * per_phase <= 3 * tile_w:
            scols, col_a, col_s, col_d = stride * per_phase, per_phase, stride, 1
            tap_col = tuple(k * dilation % stride * per_phase + k * dilation // stride
                            for k in range(3))
        else:
            scols, col_a, col_s, col_d = 3 * tile_w, tile_w, stride, dilation
            tap_col = (0, tile_w, 2 * tile_w)
        tiles_h, tiles_w = -(-ho // tile_h), -(-wo // tile_w)
        tiles = n * tiles_h * tiles_w
        cols_p = -(-cols // (8 * nt)) * 8 * nt
        tasks = gb * (cols_p // (8 * nt)) * (pixels // (16 * mt))
        slices = -(-cout_k // cols)
        blocks = tiles * (groups_k // gb) * slices
        tpb = tiles_per_block or max(1, min(MAX_TILES_PER_BLOCK, blocks // (sms * WAVES)))
        in_stages = 2 if min(tpb, tiles) * chunks > 1 else 1
        pitch = _pitch(gb * ck)
        in_bytes = srows * scols * pitch
        w_bytes = gb * cols_p * wpitch
        opitch = _pitch(gb * cols * out_itemsize)
        w_off = in_stages * in_bytes
        o_off = w_off + w_stages * w_bytes
        map_off = o_off + pixels * opitch
        ss_off = map_off + -(-4 * (srows + scols) // 16) * 16
        smem = ss_off + -(-8 * gb * cols_p // 16) * 16
        warps_ok = chunks == 1 or tasks <= THREADS // 32
        if warps_ok and smem <= min(SMEM_TARGET, smem_budget):
            break
        shorter = pixels > 128 and tile_h % 2 == 0
        if gb > 1:
            gb = max(d for d in range(1, gb) if groups_k % d == 0)
        elif not warps_ok and shorter:  # fewer rows keep a warp a column tile
            tile_h //= 2
        elif cols > 8 * nt:
            cols = max(8 * nt, cols // 2 // (8 * nt) * (8 * nt))
        elif shorter:
            tile_h //= 2
        elif warps_ok and smem <= smem_budget:
            break  # above the target, within the card's limit
        else:
            raise ValueError(f"no Q1 plan fits {smem_budget} shared bytes and {THREADS // 32} warps")
    last = cout_k - (slices - 1) * cols
    vec = _copy_bytes(cin, gb * cin_k, gb * ck, *((ck,) if chunks > 1 else ()))
    isz = out_itemsize
    ovec = _copy_bytes(cout * isz, gb * cout_k * isz, cols * isz, gb * cols * isz,
                       gb * last * isz)
    grid = -(-tiles // tpb) * (groups_k // gb) * slices
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{grid} blocks")
    if max(gb * ck // vec, 9 * (ck // gpt) // wvec, gb * cols * isz // ovec) > THREADS:
        raise ValueError(f"{THREADS} threads are fewer than the copy units of a pixel")
    return Q1Plan(gpt, ck, chunks, nt, mt, n, tile_h, tile_w, tile_w.bit_length() - 1, tiles_h,
                  tiles_w, tpb, gb, slices, cols,
                  cols_p, kpad, tasks, min(THREADS, 32 * tasks) if chunks == 1 else 32 * tasks,
                  srows, row_a, row_s, row_d, scols, col_a, col_s, col_d, y_step, tap_row,
                  tap_col, pitch, vec, wvec, wpitch, opitch, ovec, in_stages, in_bytes, w_bytes,
                  w_off, o_off, map_off, ss_off, smem, grid)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             out_dtype: torch.dtype, relu: bool) -> torch.Tensor:
    """int32 sums -> ``acc * scale + shift`` (two f32 roundings), then int8
    (rounded half to even, clipped to ``[0 if relu else -127, 127]``) or,
    ReLU optional, ``out_dtype``."""
    y = acc.float() * scale
    y = y + shift
    if out_dtype == torch.int8:
        return torch.round(y).clamp_(0.0 if relu else -127.0, 127.0).to(torch.int8)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def int8_conv3x3_acc_plain(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                           dilation: int, groups: int) -> torch.Tensor:
    """The int32 sums, (N, Ho, Wo, Cout), from an f64 conv (exact)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(), None,
                 stride, padding, dilation, groups)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv3x3_plain(x, w, scale, shift, stride: int = 1, padding: int = 1,
                       dilation: int = 1, groups: int = 1, out_dtype=torch.int8,
                       relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv3x3`."""
    acc = int8_conv3x3_acc_plain(x, w, stride, padding, dilation, groups)
    return epilogue(acc, scale, shift, out_dtype, relu).contiguous()


def int8_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                 out_dtype: torch.dtype = torch.int8, relu: bool = False) -> torch.Tensor:
    """int8 3x3 conv of NHWC ``x`` with the fused epilogue -> (N, Ho, Wo, Cout).

    Args:
        x: (N, H, W, Cin) int8, contiguous.
        w: (Cout, 3, 3, Cin / groups) int8, contiguous.
        scale, shift: (Cout,) f32 on ``x``'s device.
        out_dtype: torch.int8 (requantized), torch.float32 or torch.bfloat16.
        relu: for int8 the clip's floor is 0; for a float the result is max(y, 0).
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"int8_conv3x3 takes 4-D int8 x and w, got {x.dtype} {tuple(x.shape)} "
                         f"and {w.dtype} {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if (w.shape[1:3] != (3, 3) or groups < 1 or cin % groups or cout % groups
            or w.shape[3] != cin // groups):
        raise ValueError(f"w {tuple(w.shape)} is not (Cout, 3, 3, {cin} / {groups})")
    if scale.shape != (cout,) or shift.shape != (cout,) or scale.dtype != torch.float32 \
            or shift.dtype != torch.float32:
        raise ValueError(f"scale and shift must be ({cout},) float32")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype {out_dtype} not in {list(_OUT_KIND)}")
    if len({t.device for t in (x, w, scale, shift)}) != 1:
        raise ValueError("x, w, scale and shift must share a device")
    ho, wo = conv_out_hw(h, wd, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for a {h}x{wd} input")
    if uses_plain(KERNEL, x):
        return int8_conv3x3_plain(x, w, scale, shift, stride, padding, dilation, groups,
                                  out_dtype, relu)
    plan = q1_plan(n, h, wd, cin, cout, groups, stride, padding, dilation,
                   _ITEMSIZE[out_dtype], sms=_sm_count(x.device))
    return launch_q1(x, w, scale, shift, stride, padding, dilation, groups, out_dtype, relu,
                     plan)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_q1(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              stride: int, padding: int, dilation: int, groups: int, out_dtype: torch.dtype,
              relu: bool, plan: Q1Plan) -> torch.Tensor:
    """Launch Q1 on CUDA tensors with a given plan (the wrapper's, or one
    with another tile, channel block or thread count; the kernel refuses a
    plan that does not match the shapes)."""
    if not all(t.is_contiguous() for t in (x, w, scale, shift)) or \
            x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8_conv3x3 needs contiguous x, w, scale, shift; x and w 16-byte aligned")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = conv_out_hw(h, wd, stride, padding, dilation)
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x.device)
    args = plan.c_args()
    KERNEL.launch(ptr(x), ptr(w), ptr(scale), ptr(shift), ptr(out), n, h, wd, cin, ho, wo,
                  cout, groups, stride, padding, dilation, _OUT_KIND[out_dtype], int(relu),
                  ctypes.cast(args, ctypes.c_void_p))
    return out
