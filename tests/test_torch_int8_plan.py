"""Q1's launch plan on the CPU: a walk that follows it, bit for bit.

The CUDA kernel (``csrc/int8_conv.cu``) runs only on a card.  Its index
math is held here: :func:`walk_plan` does what each block of the kernel
does, in PyTorch, for the plan that :func:`q1_plan` gives the wrapper.  A
block's shared memory is one byte tensor, filled with random bytes first
(the kernel's shared memory holds whatever the last block left there).  For
each (tile, K chunk) item, in the kernel's order (the next item staged
before this one multiplies), the block stages the input tile with its halo
(zero off the image) and the chunk's weights (zero in the K and column
padding and, for a K tile of several groups, off its diagonal) at the
plan's offsets, pitches and copy widths; each warp task gathers its A tile
in the kernel's K order (a 32-bit register is 4 channels of one tap, an
ldmatrix row 16; a K beyond the tile's reads tap 8 from channel 0 against
zero weights) and its B tile, and multiplies them in int64; the epilogue
writes the output tile, and the copy-out scatters it.  The walk must equal
``int8_conv3x3_acc_plain`` bit for bit, and every output must be written
exactly once.
"""
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu_torch.ops.kernels import int8_conv
from vision_semantic_segmentation_tpu_torch.ops.kernels.int8_conv import (
    SMEM_LIMIT,
    conv_out_hw,
    int8_conv3x3_acc_plain,
    q1_plan,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def walk_plan(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int, dilation: int,
              groups: int, plan, out_itemsize: int = 1) -> torch.Tensor:
    """Q1's blocks in PyTorch: the int32 sums, (N, Ho, Wo, Cout) as int64."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    cin_g, cout_g = cin // groups, cout // groups
    ho, wo = conv_out_hw(h, wd, stride, padding, dilation)
    p = plan
    # the kernel's groups: K tiles of gpt groups, block-diagonal weights
    assert groups % p.gpt == 0 and p.ck % p.gpt == 0
    groups_k, cin_k, cout_k = groups // p.gpt, cin_g * p.gpt, cout_g * p.gpt
    piece = p.ck // p.gpt  # a group's channels of a tap in a K chunk
    assert p.gpt == 1 or (p.chunks == 1 and piece == cin_g)
    xf, wf = x.reshape(-1).long(), w.reshape(-1).long()
    out = torch.zeros((n, ho, wo, cout), dtype=torch.int64)
    hits = torch.zeros((n, ho, wo, cout), dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    ncb = groups_k // p.gb * p.slices
    tiles = n * p.tiles_h * p.tiles_w
    pixels = p.tile_h * p.tile_w
    run = p.gb * p.ck
    k9 = 9 * p.ck
    in_stages = p.in_stages
    assert in_stages == (2 if min(p.tpb, tiles) * p.chunks > 1 else 1)
    w_stages = 2 if p.chunks > 1 else 1
    # the regions of shared memory and the copies' alignment
    assert p.smem <= SMEM_LIMIT and p.threads <= int8_conv.THREADS and p.threads % 32 == 0
    assert p.w_off >= in_stages * p.in_bytes and p.o_off >= p.w_off + w_stages * p.w_bytes
    assert p.map_off >= p.o_off + pixels * p.opitch
    assert p.smem >= p.map_off + 4 * (p.srows + p.scols) and p.map_off % 16 == 0
    assert p.tile_w == 1 << p.tw_shift and p.tile_w >= 16  # rows of an m16 tile share y
    # each copy loop gives a thread one unit of a pixel or a weight row
    assert max(run // p.vec, 9 * piece // p.wvec, p.gb * p.cols * out_itemsize // p.ovec) \
        <= p.threads
    assert p.smem >= p.ss_off + 8 * p.gb * p.cols_p and p.ss_off >= p.map_off + 4 * (p.srows + p.scols)
    assert p.in_bytes >= p.srows * p.scols * p.pitch and p.pitch >= run
    assert p.w_bytes >= p.gb * p.cols_p * p.wpitch and p.wpitch >= p.kpad
    assert p.opitch >= p.gb * p.cols * out_itemsize
    assert all(v % 16 == 0 for v in (p.pitch, p.wpitch, p.opitch, p.in_bytes, p.w_bytes,
                                     p.w_off, p.o_off))
    assert run % p.vec == 0 and cin % p.vec == 0 and (p.gb * cin_k) % p.vec == 0
    assert piece % p.wvec == 0 and cin_g % p.wvec == 0
    assert p.chunks == 1 or p.ck % p.vec == 0  # a copy stays inside one group's chunk
    assert p.chunks == 1 or p.tasks == p.threads // 32  # one task a warp across chunks
    assert pixels % (16 * p.mt) == 0 and p.cols_p % (8 * p.nt) == 0 and p.mt * p.nt == 8
    assert p.n == n and p.tiles_h * p.tile_h >= ho and p.tiles_w * p.tile_w >= wo
    assert p.grid == -(-tiles // p.tpb) * ncb

    # the lanes' A offsets: with ck >= 16 an ldmatrix row is 16 bytes of K
    # (32 ks + 16 h ..), else a 32-bit register is 4 (32 ks + 16 h + 4 t ..);
    # byte e of it reads offset + e, K padding reads tap 8 at channel 0
    ks = torch.arange(p.kpad)
    unit = 16 if p.ck >= 16 else 4
    k0 = ks // unit * unit
    tap, c = k0 // p.ck, k0 % p.ck
    c = torch.where(tap > 8, torch.zeros_like(c), c)
    tap = tap.clamp(max=8)
    tap_row, tap_col = torch.tensor(p.tap_row), torch.tensor(p.tap_col)
    a_off = (tap_row[tap // 3] * p.scols + tap_col[tap % 3]) * p.pitch + c + ks % unit
    mr_n, nr_n = pixels // (16 * p.mt), p.cols_p // (8 * p.nt)
    wrows = p.gb * p.cols_p

    def task_of(task):
        mr, rest = task % mr_n, task // mr_n
        return mr, rest % nr_n, rest // nr_n  # m range, n range, group of the block

    def tile_at(tile):
        tx, rest = tile % p.tiles_w, tile // p.tiles_w
        return rest // p.tiles_h, rest % p.tiles_h * p.tile_h, tx * p.tile_w

    for bid in range(p.grid):
        cb, tile0 = bid % ncb, bid // ncb * p.tpb
        g0, sl = cb // p.slices * p.gb, cb % p.slices
        ocols = min(p.cols, cout_k - sl * p.cols)
        smem = torch.randint(-128, 128, (p.smem,), generator=gen, dtype=torch.int64)
        written = torch.zeros(p.smem, dtype=torch.bool)
        # zero the weights no copy writes: K padding, padded columns; with
        # K tiles of several groups the whole stage
        r = torch.arange(wrows)[:, None]
        kk = torch.arange(p.kpad)[None, :]
        zero = (kk >= k9) | (r % p.cols_p >= ocols) | (p.gpt > 1)
        for b in range(w_stages):
            idx = (p.w_off + b * p.w_bytes + r * p.wpitch + kk)[zero]
            smem[idx] = 0
            written[idx] = True
        items = min(p.tpb, tiles - tile0) * p.chunks
        depth = 1  # two stages: the next item's copies fly while one multiplies

        def stage(item):
            """Item ``item``'s copies into its stage, as the kernel issues them."""
            j, buf = item % p.chunks, item % in_stages
            img, oy0, ox0 = tile_at(tile0 + item // p.chunks)
            iy0, ix0 = oy0 * stride - padding, ox0 * stride - padding
            # the input stage: (staged row, staged column, byte of the pixel)
            in_base = buf * p.in_bytes
            written[in_base:in_base + p.in_bytes] = False
            rr = torch.arange(p.srows)[:, None, None]
            cc = torch.arange(p.scols)[None, :, None]
            bb = torch.arange(run)[None, None, :]
            gy = iy0 + rr % p.row_a * p.row_s + rr // p.row_a * p.row_d
            gx = ix0 + cc % p.col_a * p.col_s + cc // p.col_a * p.col_d
            seg = bb // p.ck
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
            src = (((img * h + gy.clamp(0, h - 1)) * wd + gx.clamp(0, wd - 1)) * cin
                   + (g0 + seg) * cin_k + j * p.ck + bb - seg * p.ck)
            val = torch.where(inside, xf[src], torch.zeros_like(src))
            dst = (in_base + (rr * p.scols + cc) * p.pitch + bb).expand_as(val)
            smem[dst.reshape(-1)] = val.reshape(-1)
            written[dst.reshape(-1)] = True
            # the weight stage: (row, tap, channel of the chunk), rows of real
            # columns; with one chunk only the block's first item stages them
            if p.chunks > 1 or item == 0:
                w_base = p.w_off + (buf if p.chunks > 1 else 0) * p.w_bytes
                wr = torch.arange(wrows)
                wr = wr[wr % p.cols_p < ocols][:, None, None]
                tt = torch.arange(9)[None, :, None]
                ch = torch.arange(piece)[None, None, :]
                ce = sl * p.cols + wr % p.cols_p  # the column in its K tile
                co = (g0 + wr // p.cols_p) * cout_k + ce
                src = co * 9 * cin_g + tt * cin_g + j * piece + ch
                dst = w_base + wr * p.wpitch + tt * p.ck + ce // cout_g * piece + ch
                smem[dst.reshape(-1)] = wf[src.reshape(-1)]
                written[dst.reshape(-1)] = True

        # the pipeline: item + depth's copies land before item multiplies
        acc = {}
        for item in range(min(depth, items)):
            stage(item)
        for item in range(items):
            if item + depth < items:
                stage(item + depth)
            j, buf = item % p.chunks, item % in_stages
            img, oy0, ox0 = tile_at(tile0 + item // p.chunks)
            in_base = buf * p.in_bytes
            w_base = p.w_off + (buf if p.chunks > 1 else 0) * p.w_bytes
            for task in range(p.tasks):
                mr, nr, gi = task_of(task)
                pix = mr * 16 * p.mt + torch.arange(16 * p.mt)
                y, xx = pix // p.tile_w, pix % p.tile_w
                row_base = (y * p.y_step * p.scols + xx) * p.pitch + gi * p.ck
                a_idx = in_base + row_base[:, None] + a_off[None, :]
                assert a_idx.min() >= in_base and a_idx.max() < in_base + p.in_bytes
                assert bool(written[a_idx[:, :k9]].all())  # K inside the group reads this item's bytes
                wrow = gi * p.cols_p + nr * 8 * p.nt + torch.arange(8 * p.nt)
                b_idx = w_base + wrow[:, None] * p.wpitch + ks[None, :]
                assert bool(written[b_idx].all())
                # ldmatrix rows start on 16 bytes: B always, A with ck >= 16
                assert bool((b_idx[:, ::16] % 16 == 0).all())
                assert p.ck < 16 or bool((a_idx[:, ::16] % 16 == 0).all())
                prod = smem[a_idx] @ smem[b_idx].T
                acc[task] = prod if j == 0 else acc[task] + prod
            if j < p.chunks - 1:
                continue
            # the epilogue into the output tile, then the copy-out
            tile = torch.full((pixels, p.gb * ocols), -1, dtype=torch.int64)
            seen = torch.zeros((pixels, p.gb * ocols), dtype=torch.int64)
            for task, a in acc.items():
                mr, nr, gi = task_of(task)
                pix = mr * 16 * p.mt + torch.arange(16 * p.mt)
                col = nr * 8 * p.nt + torch.arange(8 * p.nt)
                keep = col < ocols
                tile[pix[:, None], (gi * ocols + col[keep])[None, :]] = a[:, keep]
                seen[pix[:, None], (gi * ocols + col[keep])[None, :]] += 1
            assert bool((seen == 1).all())
            assert (p.gb * ocols * out_itemsize) % p.ovec == 0
            y, xx = torch.arange(pixels) // p.tile_w, torch.arange(pixels) % p.tile_w
            oy, ox = oy0 + y, ox0 + xx
            ok = (oy < ho) & (ox < wo)
            chan0 = g0 * cout_k + sl * p.cols
            assert (chan0 * out_itemsize) % p.ovec == 0 and (cout * out_itemsize) % p.ovec == 0
            chans = slice(chan0, chan0 + p.gb * ocols)
            out[img, oy[ok], ox[ok], chans] = tile[ok]
            hits[img, oy[ok], ox[ok], chans] += 1
    assert bool((hits == 1).all()), "an output written other than once"
    return out


def _inputs(seed, n, h, w, cin, cout, groups):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, cin)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-128, 128, (cout, 3, 3, cin // groups)).astype(np.int8))
    return x, wt


# test_torch_int8_conv.py's CASES that the card takes, then ragged tiles,
# chunked K, column slices, band-staged tiles and a stride of 3
CASES = [  # (N, H, W, Cin, Cout, groups, stride, padding, dilation)
    (1, 9, 11, 128, 128, 32, 1, 1, 1),     # ResNeXt layer1: 4 channels a group
    (2, 12, 10, 256, 256, 32, 2, 1, 1),    # layer2_0: 8 a group, strided, two images
    (1, 10, 13, 512, 512, 32, 1, 2, 2),    # layer3: 16 a group, dilation 2
    (1, 11, 9, 1024, 1024, 32, 1, 4, 4),   # layer4: 32 a group, dilation 4
    (1, 13, 12, 64, 128, 1, 2, 1, 1),      # BasicBlock conv1: dense, strided, 2 K chunks
    (1, 7, 8, 64, 64, 1, 1, 2, 2),         # BasicBlock conv2, dilated
    (1, 5, 9, 16, 8, 2, 2, 3, 2),          # padding beyond the dilation, 8 in / 4 out
    (1, 19, 37, 128, 128, 32, 1, 1, 1),    # ragged in both axes, three column tiles
    (1, 21, 35, 256, 256, 32, 2, 1, 1),    # strided, ragged
    (1, 17, 18, 48, 80, 4, 1, 1, 1),       # 12 in a group (3 chunks of 4), 20 out (nt 4)
    (1, 10, 20, 72, 72, 1, 1, 1, 1),       # dense 72: chunks of 8, column slices of 32, 8 left
    (1, 30, 26, 64, 64, 16, 1, 12, 12),    # band-staged rows and columns
    (1, 20, 22, 32, 32, 8, 3, 2, 1),       # stride 3
    (1, 9, 10, 96, 96, 3, 1, 0, 2),        # 32 a group, 3 groups, no padding
    (1, 10, 17, 32, 64, 8, 1, 1, 1),       # K tile of 8 groups of 4 in, 8 out: 64 columns
]


def _case_id(c):
    return f"n{c[0]}-{c[1]}x{c[2]}-cin{c[3]}-cout{c[4]}-g{c[5]}-s{c[6]}-p{c[7]}-d{c[8]}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_walk_equals_plain_bit_for_bit(case):
    n, h, w, cin, cout, groups, stride, padding, dilation = case
    x, wt = _inputs(sum(case), n, h, w, cin, cout, groups)
    plan = q1_plan(n, h, w, cin, cout, groups, stride, padding, dilation, 1)
    got = walk_plan(x, wt, stride, padding, dilation, groups, plan)
    want = int8_conv3x3_acc_plain(x, wt, stride, padding, dilation, groups)
    torch.testing.assert_close(got, want.long(), rtol=0, atol=0)


# other launch choices: small channel blocks and shared memory, wide and
# tall tiles, runs of tiles a block (across rows and images, a short last
# run, with chunks)
CHOICES = [  # (case index, tile, block_cols, tiles a block, shared budget, out itemsize)
    (3, (8, 16), 64, None, 48 * 1024, 2),
    (0, (4, 32), 16, None, SMEM_LIMIT, 4),
    (4, (8, 32), 32, 2, 160 * 1024, 1),
    (9, (8, 16), 128, 2, 48 * 1024, 2),
    (11, (2, 64), 128, None, SMEM_LIMIT, 1),
    (7, (8, 16), 128, 2, SMEM_LIMIT, 1),
    (1, (8, 16), 64, 3, SMEM_LIMIT, 4),
    (8, (4, 32), 128, 4, SMEM_LIMIT, 2),
    (14, (8, 16), 32, None, SMEM_LIMIT, 1),  # a K tile in two column slices
    (7, (8, 16), 64, 4, SMEM_LIMIT, 1),  # runs of 4, 4 and 1 tiles
    (8, (16, 16), 32, None, 64 * 1024, 1),  # shared memory short: 8 of 16 rows
]


@pytest.mark.parametrize("index,tile,block_cols,tpb,budget,itemsize", CHOICES,
                         ids=[f"{_case_id(CASES[c[0]])}-{c[1][0]}x{c[1][1]}-{c[2]}-{c[3]}-{c[4]}"
                              for c in CHOICES])
def test_launch_choices_walk_bit_for_bit(index, tile, block_cols, tpb, budget, itemsize):
    n, h, w, cin, cout, groups, stride, padding, dilation = CASES[index]
    x, wt = _inputs(index, n, h, w, cin, cout, groups)
    plan = q1_plan(n, h, w, cin, cout, groups, stride, padding, dilation, itemsize, tile=tile,
                   block_cols=block_cols, tiles_per_block=tpb, smem_budget=budget)
    assert plan.smem <= budget and plan.tpb == (tpb or plan.tpb)
    got = walk_plan(x, wt, stride, padding, dilation, groups, plan, itemsize)
    want = int8_conv3x3_acc_plain(x, wt, stride, padding, dilation, groups)
    torch.testing.assert_close(got, want.long(), rtol=0, atol=0)


def _covers_once(plan, n, ho, wo, cout, groups):
    """Every output (image, row, column, channel) lies in exactly one block:
    a block is a channel block times a run of tiles, and the tiles the
    product of row and column tiles, so each is checked on its own."""
    groups, cout_g = groups // plan.gpt, cout // groups * plan.gpt  # K tiles
    for size, step, count in ((ho, plan.tile_h, plan.tiles_h), (wo, plan.tile_w, plan.tiles_w)):
        hits = np.zeros(size, int)
        for t in range(count):
            hits[t * step:min((t + 1) * step, size)] += 1
        assert (hits == 1).all() and (count - 1) * step < size
    hits = np.zeros(cout, int)
    for cb in range(groups // plan.gb * plan.slices):
        g0, sl = cb // plan.slices * plan.gb, cb % plan.slices
        ocols = min(plan.cols, cout_g - sl * plan.cols)
        assert ocols > 0
        for gi in range(plan.gb):
            start = (g0 + gi) * cout_g + sl * plan.cols
            hits[start:start + ocols] += 1
    assert (hits == 1).all()
    tiles = n * plan.tiles_h * plan.tiles_w
    hits = np.zeros(tiles, int)
    for q in range(-(-tiles // plan.tpb)):
        hits[q * plan.tpb:(q + 1) * plan.tpb] += 1
    assert (hits == 1).all()
    assert plan.grid == -(-tiles // plan.tpb) * groups // plan.gb * plan.slices


# chip_smoke.py's Q1 site shapes (Q1_SITES, Q1_BASIC), then the 4-band
# halo-extended inputs of phase 13(c): (N, H, W, Cin, Cout, groups, stride,
# padding, dilation)
SITES = [
    (1, 360, 480, 128, 128, 32, 1, 1, 1), (1, 360, 480, 256, 256, 32, 2, 1, 1),
    (1, 180, 240, 256, 256, 32, 1, 1, 1), (1, 180, 240, 512, 512, 32, 1, 1, 1),
    (1, 180, 240, 512, 512, 32, 1, 2, 2), (1, 180, 240, 1024, 1024, 32, 1, 2, 2),
    (1, 180, 240, 1024, 1024, 32, 1, 4, 4),
    (1, 360, 480, 64, 128, 1, 2, 1, 1), (1, 180, 240, 128, 128, 1, 1, 1, 1),
    (1, 91, 480, 128, 128, 32, 1, 1, 1), (1, 92, 480, 128, 128, 32, 1, 1, 1),
    (1, 92, 480, 256, 256, 32, 2, 1, 1), (1, 46, 240, 256, 256, 32, 1, 1, 1),
    (1, 47, 240, 512, 512, 32, 1, 2, 2), (1, 49, 240, 512, 512, 32, 1, 2, 2),
    (1, 49, 240, 1024, 1024, 32, 1, 4, 4), (1, 53, 240, 1024, 1024, 32, 1, 4, 4),
]


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("site", SITES, ids=[_case_id(s) for s in SITES])
def test_site_plans_fit_and_cover_once(site, itemsize):
    n, h, w, cin, cout, groups, stride, padding, dilation = site
    plan = q1_plan(n, h, w, cin, cout, groups, stride, padding, dilation, itemsize)
    assert plan.smem <= SMEM_LIMIT
    assert plan.threads == min(256, 32 * plan.tasks)
    _covers_once(plan, n, *conv_out_hw(h, w, stride, padding, dilation), cout, groups)


def test_main_shape_plans():
    """The plans of layer 4 and layer 1 at 1440x1920: whole groups a block,
    16-byte copies in and out, a run of tiles a block that still fills the
    card's SMs."""
    p4 = q1_plan(1, 180, 240, 1024, 1024, 32, 1, 4, 4, 1)
    assert (p4.ck, p4.chunks, p4.nt, p4.slices, p4.vec, p4.ovec) == (32, 1, 4, 1, 16, 16)
    assert p4.tap_row == (0, 4, 8) and p4.tap_col == (0, 4, 8)
    assert p4.tpb > 1 and p4.grid >= 132 * int8_conv.WAVES
    # the run of tiles a block follows the card's SM count (layer2_1-3)
    runs = {sms: q1_plan(1, 180, 240, 256, 256, 32, 1, 1, 1, 1, sms=sms).tpb
            for sms in (66, 114, 132, 264)}
    assert runs == {66: 4, 114: 3, 132: 2, 264: 1}
    p1 = q1_plan(1, 360, 480, 128, 128, 32, 1, 1, 1, 1)  # K tiles of 8 groups of 4
    assert (p1.gpt, p1.ck, p1.kpad, p1.nt, p1.mt, p1.wvec) == (8, 32, 288, 4, 2, 4)
    p2 = q1_plan(1, 180, 240, 256, 256, 32, 1, 1, 1, 1)  # K tiles of 4 groups of 8
    assert (p2.gpt, p2.ck, p2.nt, p2.wvec) == (4, 32, 4, 8)
    p3 = q1_plan(1, 180, 240, 512, 512, 32, 1, 2, 2, 1)  # 16 a group: one group a K tile
    assert (p3.gpt, p3.ck, p3.kpad, p3.nt) == (1, 16, 160, 2)
    s2 = q1_plan(1, 360, 480, 256, 256, 32, 2, 1, 1, 1)  # stride 2: two column phases
    assert (s2.col_a, s2.col_s, s2.col_d, s2.y_step, s2.tap_col) == (17, 2, 1, 2, (0, 17, 1))


REFUSED = [  # (N, H, W, Cin, Cout, groups, stride, padding, dilation), message
    ((1, 6, 7, 32, 48, 8, 1, 0, 1), "multiples of 4"),   # 6 out a group
    ((1, 6, 7, 24, 48, 4, 1, 1, 1), "multiples of 4"),   # 6 in a group
    ((1, 6, 7, 32, 48, 5, 1, 1, 1), "do not divide"),
    ((1, 2, 2, 8, 8, 1, 1, 0, 1), "empty"),
    ((1, 6, 7, 8, 8, 1, 0, 1, 1), "stride"),
    ((1, 6, 7, 8, 8, 1, 1, 1, 0), "dilation"),
]


@pytest.mark.parametrize("case,match", REFUSED, ids=[r[1].split()[0] + str(i)
                                                     for i, r in enumerate(REFUSED)])
def test_plan_refuses_what_the_wrapper_refuses(case, match):
    with pytest.raises(ValueError, match=match):
        q1_plan(*case, 1)


def test_plan_refuses_bad_launch_choices():
    with pytest.raises(ValueError, match="128 pixels"):
        q1_plan(1, 9, 9, 32, 32, 1, 1, 1, 1, 1, tile=(4, 16))
    with pytest.raises(ValueError, match="power of 2"):
        q1_plan(1, 9, 9, 32, 32, 1, 1, 1, 1, 1, tile=(16, 24))
    with pytest.raises(ValueError, match="fits"):
        q1_plan(1, 9, 9, 32, 32, 1, 1, 1, 1, 1, smem_budget=1024)


def test_wrapper_on_cuda_refuses_before_launching(monkeypatch):
    """The wrapper's refusals on the kernel route, which a CPU tensor
    reaches with the plain-version test hook turned the other way (and the
    card's SM count, which the kernel route reads, the H100's)."""
    monkeypatch.setattr(int8_conv, "uses_plain", lambda kernel, t: False)
    monkeypatch.setattr(int8_conv, "_sm_count", lambda device: 132)
    s = torch.ones(48)
    x = torch.zeros((1, 6, 7, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_conv.int8_conv3x3(x, torch.zeros((48, 3, 3, 4), dtype=torch.int8), s, s, groups=8)
    w = torch.zeros((48, 3, 3, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv3x3(x.transpose(1, 2).contiguous().transpose(1, 2), w, s, s)
    launches = int8_conv.KERNEL.launches
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv3x3(x, w, torch.ones(96)[::2], s)
    assert int8_conv.KERNEL.launches == launches
