"""K3's and P1/P2's launch plan on the CPU: a walk that follows it, bit for bit.

The CUDA kernels (``csrc/phase.cuh``, instantiated by ``csrc/depthwise.cu``
and ``csrc/depthwise_hoist.cu``) run only on a card.  Their index math is
held here: :func:`walk_plan` does what each block of the kernel does, in
PyTorch, for the plan that :func:`depthwise_plan` gives the wrappers.  A
block stages its phase sub-tile, with a border of one phase pixel, into a
flat buffer of ``pitch`` elements a row, in the input's type or as f32; its
walkers go along the tile's columns (K3) or rows (P1/P2), read the three
taps across the line at each staged pixel, add them to the three running
sums that use them and scatter each finished pixel back.  The walk must
equal the plain versions (``depthwise3x3_dilated_plain`` row-major,
``hoisted_plain`` column-major) bit for bit in f32 and bf16.
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise, depthwise_hoist
from vision_semantic_segmentation_tpu_torch.ops.kernels.depthwise import (
    SMEM_LIMIT,
    depthwise3x3_dilated_plain,
    depthwise_plan,
    launch_depthwise,
)
from vision_semantic_segmentation_tpu_torch.ops.kernels.depthwise_hoist import hoisted_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel -> (walks along rows: column-major sums, tile held as f32, plain version)
KINDS = {
    "k3": (False, False, depthwise3x3_dilated_plain),
    "f32col": (True, False, hoisted_plain),
    "slab": (True, True, hoisted_plain),
}


def walk_plan(x, w9, d, plan, column_major, staged_dtype):
    """The kernel's blocks in PyTorch: (1, H, W, C) -> (1, H, W, C).

    Phases of equal shape run together (at most four shapes, H and W each
    ragged or not); each (phase shape, sub-tile, channel group) is one block
    of the kernel for every phase of that shape.
    """
    _, h, w, c = x.shape
    img = x[0]
    y = torch.full_like(img, float("nan"))
    shapes = {}
    for pr in range(min(d, h)):
        for pc in range(min(d, w)):
            shapes.setdefault((-(-(h - pr) // d), -(-(w - pc) // d)), []).append((pr, pc))
    tiles_r = -(-(-(-h // d)) // plan.tile_h)
    tiles_c = -(-(-(-w // d)) // plan.tile_w)
    for (hp, wp), phases in shapes.items():
        prs = torch.tensor([p[0] for p in phases])[:, None]
        pcs = torch.tensor([p[1] for p in phases])[:, None]
        for tr in range(tiles_r):
            for tc in range(tiles_c):
                r0, c0 = tr * plan.tile_h, tc * plan.tile_w
                if r0 >= hp or c0 >= wp:
                    continue
                for ch0 in range(0, c, plan.group):
                    chans = slice(ch0, min(ch0 + plan.group, c))
                    _block(img, y, w9[:, chans], chans, d, plan, column_major, staged_dtype,
                           prs, pcs, hp, wp, r0, c0)
    return y[None]


def _block(img, y, w9, chans, d, plan, column_major, staged_dtype, prs, pcs, hp, wp, r0, c0):
    orows, ocols = min(plan.tile_h, hp - r0), min(plan.tile_w, wp - c0)
    scols = ocols + 2
    ch = torch.arange(chans.stop - chans.start)
    # staging: flat staged pixel -> staged (a, b) = phase (r0 - 1 + a, c0 - 1 + b),
    # zero off the phase image; NaN marks what no thread staged
    tile = torch.full((len(prs), (plan.tile_h + 2) * plan.pitch), float("nan"), dtype=staged_dtype)
    pix = torch.arange((orows + 2) * scols)
    a, b = pix // scols, pix % scols
    row, col = r0 - 1 + a, c0 - 1 + b
    inside = (row >= 0) & (row < hp) & (col >= 0) & (col < wp)
    vals = img[prs + d * row.clamp(0, hp - 1), pcs + d * col.clamp(0, wp - 1), chans]
    vals = torch.where(inside[None, :, None], vals, torch.zeros_like(vals))
    tile[:, (a * plan.pitch + b * plan.group)[:, None] + ch] = vals.to(staged_dtype)

    # walkers: every line at once.  Staged pixel t of a line holds tap 0
    # (along the line) of output t, tap 1 of t - 1 and tap 2 of t - 2
    lines, n = (orows, ocols) if column_major else (ocols, orows)
    walk, across = (plan.group, plan.pitch) if column_major else (plan.pitch, plan.group)
    item = torch.arange(lines)
    acc = {}
    for t in range(n + 2):
        for m in range(3):
            xv = tile[:, (item * across + t * walk + m * across)[:, None] + ch].float()
            for along, out in ((0, t), (1, t - 1), (2, t - 2)):
                if 0 <= out < n:
                    tap = m * 3 + along if column_major else along * 3 + m
                    term = xv * w9[tap]
                    acc[out] = term if along == 0 and m == 0 else acc[out] + term
        if t >= 2:
            done = acc.pop(t - 2).to(y.dtype)
            if column_major:
                y[prs + d * (r0 + item), pcs + d * (c0 + t - 2), chans] = done
            else:
                y[prs + d * (r0 + t - 2), pcs + d * (c0 + item), chans] = done
    assert not acc


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w9 = torch.from_numpy(rng.standard_normal((9, shape[-1])).astype(np.float32))
    return x, w9


# (id, shape, dilation, arguments of the plan).  The main shape's plans are
# those of (180, 240, 2048), walked on 136 channels (a whole channel group
# and a partial one at the widest) to stay small.
CASES = [
    ("ragged_partial_group", (1, 37, 53, 72), 12, dict(group_bytes=64)),
    ("ragged", (1, 37, 53, 72), 24, {}),
    ("d1_sub_tiles", (1, 40, 44, 16), 1, dict(smem_budget=4096)),
    ("d_above_h", (1, 9, 13, 24), 20, {}),
    ("c20_unaligned", (1, 37, 53, 20), 12, dict(aligned=False)),
    ("main_d12", (1, 180, 240, 136), 12, dict(c=2048)),
    ("main_d24", (1, 180, 240, 136), 24, dict(c=2048)),
    ("main_d36", (1, 180, 240, 136), 36, dict(c=2048)),
]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,shape,d,plan_args", CASES, ids=[c[0] for c in CASES])
def test_walk_equals_plain_bit_for_bit(name, shape, d, plan_args, kind, dt):
    column_major, f32_tile, plain = KINDS[kind]
    x, w9 = _inputs(shape, seed=len(name))
    x = x.to(DTYPES[dt])
    _, h, w, c = shape
    args = dict(plan_args)
    staged_dtype = torch.float32 if f32_tile else x.dtype
    plan = depthwise_plan(h, w, args.pop("c", c), d, x.element_size(),
                          torch.tensor([], dtype=staged_dtype).element_size(), **args)
    assert plan.smem <= SMEM_LIMIT
    if name == "ragged_partial_group":
        assert c % plan.group != 0
    if name == "d1_sub_tiles":
        assert plan.tile_h * plan.tile_w < 40 * 44
    if name == "c20_unaligned":
        assert plan.vector == 1
    got = walk_plan(x, w9, d, plan, column_major, staged_dtype)
    torch.testing.assert_close(got, plain(x, w9, d), rtol=0, atol=0)


def test_main_path_plans():
    """bf16 (1, 180, 240, 2048): one 15x20 / 8x10 / 5x7 phase a tile, and
    channel groups that grow as the phase shrinks: the widest whose tile
    stays within WALK_TILE_BYTES (the least group where none does)."""
    for staged, groups in ((2, (32, 128, 256)), (4, (32, 64, 128))):
        for d, tile, group in zip((12, 24, 36), ((15, 20), (8, 10), (5, 7)), groups):
            plan = depthwise_plan(180, 240, 2048, d, 2, staged)
            assert (plan.tile_h, plan.tile_w, plan.vector, plan.threads) == (*tile, 4, 128)
            assert plan.group == group
            assert plan.smem <= depthwise.WALK_TILE_BYTES or group == 32
            wider = depthwise_plan(180, 240, 2048, d, 2, staged, group_bytes=4 * group,
                                   smem_budget=SMEM_LIMIT)
            assert wider.smem > depthwise.WALK_TILE_BYTES
    plan = depthwise_plan(180, 240, 2048, 12, 2)
    assert plan.pitch == 22 * 32 + 32  # 64-byte pixels: rows offset by 64 bytes
    assert plan.smem == 17 * plan.pitch * 2
    slab = depthwise_plan(180, 240, 2048, 12, 2, 4)
    assert slab.pitch == 22 * 32 and slab.smem == 17 * slab.pitch * 4  # 128-byte pixels: no padding


@pytest.mark.parametrize("shape,d,itemsize,staged,aligned", [
    ((1, 180, 240, 2048), 12, 2, 2, True),
    ((1, 180, 240, 2048), 36, 2, 4, True),
    ((1, 180, 240, 2048), 1, 2, 2, True),   # one 180x240 phase: sub-tiles
    ((1, 180, 240, 2048), 2, 4, 4, True),
    ((1, 37, 53, 20), 12, 2, 2, True),      # C % 8 != 0: scalar path
    ((1, 37, 53, 72), 12, 2, 4, False),     # unaligned input: scalar path
    ((1, 20, 28, 40), 64, 2, 4, True),      # d > 56
    ((1, 20, 28, 40), 200, 4, 4, True),     # d > H and W: phases of one pixel
    ((1, 4000, 3000, 512), 3, 4, 4, True),
])
def test_plans_fit_shared_memory(shape, d, itemsize, staged, aligned):
    _, h, w, c = shape
    plan = depthwise_plan(h, w, c, d, itemsize, staged, aligned=aligned)
    assert 0 < plan.smem <= depthwise.WALK_SMEM_BUDGET <= SMEM_LIMIT
    assert 1 <= plan.tile_h <= -(-h // d) and 1 <= plan.tile_w <= -(-w // d)
    assert plan.pitch >= (plan.tile_w + 2) * plan.group
    assert plan.smem == -(-(plan.tile_h + 2) * plan.pitch * staged // 16) * 16
    vector = 4 if aligned and c % (16 // itemsize) == 0 else 1
    assert plan.vector == vector and plan.group % (16 // itemsize if vector > 1 else 1) == 0
    assert plan.group % plan.vector == 0 and plan.threads % (plan.group // plan.vector) == 0
    assert plan.threads <= 256
    if vector > 1:
        assert plan.pitch * staged % 16 == 0
    if plan.group * staged < 128:  # rows start 128-byte-disjoint
        assert plan.pitch * staged % 128 == plan.group * staged


def test_plan_rejects_what_cannot_run():
    with pytest.raises(ValueError, match="dilation"):
        depthwise_plan(8, 8, 8, 0, 4)
    with pytest.raises(ValueError, match="exceed"):
        depthwise_plan(8, 8, 256, 1, 4, group_bytes=1024, smem_budget=8192)


@pytest.mark.parametrize("kernel", [depthwise.KERNEL, depthwise_hoist.HOISTED,
                                    depthwise_hoist.VARIANTS["slab"]], ids=lambda k: k.name)
def test_launcher_refuses_what_the_kernel_cannot_take(kernel):
    """The plan's launcher checks before it hands pointers to the kernel."""
    x, w9 = _inputs((1, 8, 8, 16), seed=1)
    plan = depthwise_plan(8, 8, 16, 2, 4)
    with pytest.raises(ValueError, match="on the card"):
        launch_depthwise(kernel, x, w9, 2, plan)  # a CPU tensor
    with pytest.raises(ValueError, match="NHWC"):
        launch_depthwise(kernel, x[0], w9, 2, plan)
    with pytest.raises(ValueError, match="dtype"):
        launch_depthwise(kernel, x.double(), w9, 2, plan)
