"""K4's launch plan on the CPU: a walk that follows it, bit for bit.

The CUDA kernel (``csrc/aspp_depthwise.cu``) runs only on a card.  Its
index math is held here: :func:`walk_plan` does what each block of the
kernel does, in PyTorch, for the plan that :func:`aspp_plan` gives the
wrapper.  A block stages its phase sub-tile with a zero border of ``halo``
phase pixels by the kernel's flat pixel index; its walkers go down each output column in steps of d / g, one
per row residue, read each row's taps at +-d / g phase pixels from that
tile (from the input where a cut halo leaves a tap outside it, zero off the
image), add them to the three running sums that use the row, and scatter
each finished pixel back.  The walk must equal the plain version
(``aspp_depthwise3x3_multi_plain``) bit for bit in f32 and bf16.
"""
import math

import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.ops.kernels.depthwise import (
    SMEM_LIMIT,
    aspp_depthwise3x3_multi_plain,
    aspp_plan,
    launch_multi,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def walk_plan(x: torch.Tensor, w9s: torch.Tensor, dilations, plan) -> list:
    """K4's blocks in PyTorch: (1, H, W, C) -> one (1, H, W, C) per branch.

    Phases of equal shape run together (at most four shapes, H and W each
    ragged or not); each (phase shape, sub-tile, channel group) is one block
    of the kernel for every phase of that shape.
    """
    _, h, w, c = x.shape
    g = plan.g
    img = x[0]
    y = torch.zeros((len(dilations), h, w, c), dtype=x.dtype)
    shapes = {}
    for pr in range(min(g, h)):
        for pc in range(min(g, w)):
            shapes.setdefault((-(-(h - pr) // g), -(-(w - pc) // g)), []).append((pr, pc))
    tiles_r = -(-(-(-h // g)) // plan.tile_h)
    tiles_c = -(-(-(-w // g)) // plan.tile_w)
    for (hp, wp), phases in shapes.items():
        prs = torch.tensor([p[0] for p in phases])[:, None]
        pcs = torch.tensor([p[1] for p in phases])[:, None]
        for tr in range(tiles_r):
            for tc in range(tiles_c):
                r0, c0 = tr * plan.tile_h, tc * plan.tile_w
                if r0 >= hp or c0 >= wp:
                    continue
                box = (r0, min(r0 + plan.tile_h, hp), c0, min(c0 + plan.tile_w, wp))
                for ch0 in range(0, c, plan.group):
                    chans = slice(ch0, min(ch0 + plan.group, c))
                    _block(img, y, w9s[:, :, chans], chans, plan, prs, pcs, hp, wp, box)
    return [y[b : b + 1] for b in range(len(dilations))]


def _block(img, y, w9s, chans, plan, prs, pcs, hp, wp, box):
    g, halo = plan.g, plan.halo
    r0, r1, c0, c1 = box
    # staging: the sub-tile with a border of `halo` phase pixels, zero off
    # the phase image; flat staged pixel -> phase (srow0 + a, scol0 + b)
    srow0, scol0 = r0 - halo, c0 - halo
    srows, scols = r1 - r0 + 2 * halo, c1 - c0 + 2 * halo
    pix = torch.arange(srows * scols)
    a, b = pix // scols, pix % scols
    inside = (srow0 + a >= 0) & (srow0 + a < hp) & (scol0 + b >= 0) & (scol0 + b < wp)
    tile = img[prs + g * (srow0 + a).clamp(0, hp - 1), pcs + g * (scol0 + b).clamp(0, wp - 1), chans]
    tile = torch.where(inside[None, :, None], tile, torch.zeros_like(tile))

    def tap(r, col):
        """Row r's tap at columns ``col``: staged, from the image beyond a cut
        halo, or zero off the image."""
        staged = (srow0 <= r < srow0 + srows) & (col >= scol0) & (col < scol0 + scols)
        inside = (0 <= r < hp) & (col >= 0) & (col < wp)
        idx = ((r - srow0) * scols + col - scol0).clamp(0, tile.shape[1] - 1)
        from_image = img[prs + g * min(max(r, 0), hp - 1), pcs + g * col.clamp(0, wp - 1), chans]
        return torch.where(staged[None, :, None], tile[:, idx],
                           torch.where(inside[None, :, None], from_image,
                                       torch.zeros_like(from_image)))

    # walkers: per branch and row residue, down every output column at once;
    # row r is tap row 0 of output r + s, row 1 of r and row 2 of r - s
    pj = torch.arange(c0, c1)
    for b, s in enumerate(plan.steps):
        cols = [pj + (tj - 1) * s for tj in range(3)]
        for i0 in range(r0, min(r0 + s, r1)):
            last = i0 + (r1 - 1 - i0) // s * s
            acc = {}
            for r in range(i0 - s, last + s + 1, s):
                for tj, col in enumerate(cols):
                    xv = tap(r, col).float()
                    for ti, out in ((0, r + s), (1, r), (2, r - s)):
                        if i0 <= out <= last:
                            term = xv * w9s[b, ti * 3 + tj]
                            acc[out] = term if ti == 0 and tj == 0 else acc[out] + term
                if r - s >= i0:
                    y[b, prs + g * (r - s), pcs + g * pj, chans] = acc.pop(r - s).to(y.dtype)


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w9s = torch.from_numpy(rng.standard_normal((n, 9, shape[-1])).astype(np.float32))
    return x, w9s


# (id, shape, dilations, shared-memory budget or None for the card's limit)
CASES = [
    ("ragged", (1, 37, 53, 72), (12, 24, 36), None),
    ("coprime", (1, 45, 60, 256), (5, 7), None),
    ("one_branch", (1, 20, 28, 40), (3,), None),
    ("eight_branches", (1, 21, 30, 16), (2, 4, 6, 8, 10, 12, 14, 16), None),
    ("cut_halo", (1, 40, 44, 16), (1, 30), 4096),
]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name,shape,dilations,budget", CASES, ids=[c[0] for c in CASES])
def test_walk_equals_plain_bit_for_bit(name, shape, dilations, budget, dt):
    x, w9s = _inputs(shape, len(dilations), seed=len(name))
    x = x.to(DTYPES[dt])
    _, h, w, c = shape
    plan = aspp_plan(h, w, c, dilations, x.element_size(), smem_budget=budget or SMEM_LIMIT)
    got = walk_plan(x, w9s, dilations, plan)
    want = aspp_depthwise3x3_multi_plain(x, w9s, dilations)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dt", DTYPES)
def test_main_shape_halo_tiles(dt):
    """The main path's plan at (180, 240, 2048) with a small shared-memory
    budget: sub-tiles with a full halo.  Walked on 80 channels (two
    channel groups in bf16, three in f32) to stay small."""
    itemsize = torch.tensor([], dtype=DTYPES[dt]).element_size()
    full = aspp_plan(180, 240, 2048, (12, 24, 36), itemsize)
    assert (full.tile_h, full.tile_w, full.halo) == (15, 20, 3)  # one whole phase
    plan = aspp_plan(180, 240, 2048, (12, 24, 36), itemsize, smem_budget=24 * 1024)
    assert plan.tile_h * plan.tile_w < 15 * 20 and plan.halo == 3
    x, w9s = _inputs((1, 180, 240, 80), 3, seed=9)
    x = x.to(DTYPES[dt])
    got = walk_plan(x, w9s, (12, 24, 36), plan)
    want = aspp_depthwise3x3_multi_plain(x, w9s, (12, 24, 36))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_main_path_plan():
    """bf16 (1, 180, 240, 2048), d 12/24/36: 144 phases of 15x20, one tile
    each, 32 channels (64 bytes) per block."""
    plan = aspp_plan(180, 240, 2048, (12, 24, 36), 2)
    assert plan.g == 12 and plan.steps == (1, 2, 3)
    assert (plan.tile_h, plan.tile_w, plan.halo, plan.vector, plan.group) == (15, 20, 3, 4, 32)
    assert plan.smem == 21 * 26 * 32 * 2 + 3 * 9 * 32 * 4  # bordered tile, then f32 weights
    assert plan.threads == 128


@pytest.mark.parametrize("shape,dilations,itemsize,aligned", [
    ((1, 180, 240, 2048), (12, 24, 36), 2, True),
    ((1, 180, 240, 2048), (12, 24, 36), 4, True),
    ((1, 37, 53, 72), (12, 24, 36), 2, True),
    ((1, 37, 53, 20), (12, 24, 36), 2, True),  # C % 8 != 0: scalar path
    ((1, 37, 53, 72), (12, 24, 36), 2, False),  # unaligned input: scalar path
    ((1, 45, 60, 256), (5, 7), 4, True),
    ((1, 400, 500, 2048), (1, 100), 2, True),  # coprime, large d: halo cut
    ((1, 4000, 3000, 512), (2, 3), 4, True),
])
def test_plans_fit_shared_memory(shape, dilations, itemsize, aligned):
    _, h, w, c = shape
    plan = aspp_plan(h, w, c, dilations, itemsize, aligned=aligned)
    g = math.gcd(*dilations)
    ph, pw = -(-h // g), -(-w // g)
    assert plan.g == g and 0 < plan.smem <= SMEM_LIMIT
    tile = (plan.tile_h + 2 * plan.halo) * (plan.tile_w + 2 * plan.halo) * plan.group * itemsize
    assert plan.smem == -(-tile // 16) * 16 + len(dilations) * 9 * plan.group * 4
    assert 0 <= plan.halo <= max(dilations) // g
    assert plan.group % plan.vector == 0 and plan.threads % (plan.group // plan.vector) == 0
    assert plan.threads <= 256
    vector = 4 if aligned and c % (16 // itemsize) == 0 else 1
    assert plan.vector == vector and plan.group % (16 // itemsize if vector > 1 else 1) == 0


def test_plan_rejects_bad_dilations():
    with pytest.raises(ValueError):
        aspp_plan(8, 8, 8, (), 4)
    with pytest.raises(ValueError):
        aspp_plan(8, 8, 8, (0, 2), 4)


def test_launch_multi_refuses_what_the_kernel_cannot_take():
    """The plan's launcher checks before it hands pointers to the kernel."""
    x, w9s = _inputs((1, 8, 8, 16), 2, seed=1)
    plan = aspp_plan(8, 8, 16, (1, 2), 4)
    with pytest.raises(ValueError, match="on the card"):
        launch_multi(x, w9s, (1, 2), plan)  # a CPU tensor
    with pytest.raises(ValueError, match="dilations"):
        launch_multi(x, w9s, [1] * 9, plan)
