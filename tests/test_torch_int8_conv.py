"""Q1, the int8 3x3 conv (``ops/kernels/int8_conv.py``), on the CPU.

On a CPU tensor the wrapper runs its plain version: an f64 conv of the int8
values (exact) and the f32 epilogue in the JAX package's order
(``models/quant.py:394-411``).  Here it is held against a numpy int64 conv
over groups (1 and 32; 4 to 64 input channels a group), strides 1 and 2,
dilations 1, 2 and 4, padding 0 to 4, each output kind (int8 with and
without ReLU, f32, bf16), and against the JAX package's own int8 conv and
epilogue.  Every comparison is exact.  The CUDA kernel is compared with
this plain version on the card by ``chip_smoke.py`` (phase 9(a)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.models import quant as j_quant
from vision_semantic_segmentation_tpu_torch.models.quant import int8_matmul
from vision_semantic_segmentation_tpu_torch.ops.kernels import int8_conv
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CASES = [  # (N, H, W, Cin, Cout, groups, stride, padding, dilation)
    (1, 9, 11, 128, 128, 32, 1, 1, 1),    # ResNeXt layer1: 4 channels a group
    (2, 12, 10, 256, 256, 32, 2, 1, 1),   # layer2_0: 8 a group, strided
    (1, 10, 13, 512, 512, 32, 1, 2, 2),   # layer3: 16 a group, dilation 2
    (1, 11, 9, 1024, 1024, 32, 1, 4, 4),  # layer4: 32 a group, dilation 4
    (1, 13, 12, 64, 128, 1, 2, 1, 1),     # BasicBlock conv1: dense, strided
    (1, 7, 8, 64, 64, 1, 1, 2, 2),        # BasicBlock conv2, dilated
    (1, 6, 7, 32, 48, 8, 1, 0, 1),        # no padding, 4 in / 6 out a group
    (1, 5, 9, 16, 8, 2, 2, 3, 2),         # padding beyond the dilation
]


def _inputs(rng, n, h, w, cin, cout, groups):
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (cout, 3, 3, cin // groups)).astype(np.int8)
    return x, wt


def numpy_conv(x, w, stride, padding, dilation, groups):
    """int64 3x3 conv of NHWC ``x`` with (Cout, 3, 3, Cin/groups) ``w``."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    cg, og = cin // groups, cout // groups
    ho, wo = int8_conv.conv_out_hw(h, wd, stride, padding, dilation)
    xp = np.pad(x.astype(np.int64), ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    out = np.zeros((n, ho, wo, cout), np.int64)
    for ky in range(3):
        for kx in range(3):
            patch = xp[:, ky * dilation: ky * dilation + stride * (ho - 1) + 1: stride,
                       kx * dilation: kx * dilation + stride * (wo - 1) + 1: stride]
            for g in range(groups):
                out[..., g * og:(g + 1) * og] += \
                    patch[..., g * cg:(g + 1) * cg] @ w[g * og:(g + 1) * og, ky, kx].T.astype(np.int64)
    return out


def numpy_epilogue(acc, scale, shift, kind, relu):
    y = acc.astype(np.float32) * scale
    y = y + shift
    if kind == "int8":
        return np.clip(np.round(y), 0 if relu else -127, 127).astype(np.int8)
    return np.maximum(y, np.float32(0)) if relu else y


@pytest.mark.parametrize("case", CASES, ids=[f"g{c[5]}-cin{c[3]}-s{c[6]}-p{c[7]}-d{c[8]}"
                                             for c in CASES])
def test_plain_version_matches_numpy(case):
    n, h, w, cin, cout, groups, stride, padding, dilation = case
    rng = np.random.default_rng(cin + stride + dilation)
    x, wt = _inputs(rng, n, h, w, cin, cout, groups)
    want = numpy_conv(x, wt, stride, padding, dilation, groups)
    assert np.abs(want).max() < 2 ** 31
    acc = int8_conv.int8_conv3x3_acc_plain(torch.from_numpy(x), torch.from_numpy(wt), stride,
                                           padding, dilation, groups)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    # scales of a requantize (total / out_scale) put some sums near ties
    scale = (rng.uniform(0.5, 2.0, cout) / np.abs(want).max()).astype(np.float32) * 60
    shift = rng.uniform(-3, 3, cout).astype(np.float32)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    st, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    launches = int8_conv.KERNEL.launches
    for kind, dtype in (("int8", torch.int8), ("f32", torch.float32), ("bf16", torch.bfloat16)):
        for relu in (False, True):
            got = int8_conv.int8_conv3x3(xt, wtt, st, sh, stride, padding, dilation, groups,
                                         dtype, relu)
            ref = numpy_epilogue(want, scale, shift, kind, relu)
            assert got.dtype == dtype and got.is_contiguous()
            if kind == "bf16":
                np.testing.assert_array_equal(got.float().numpy(),
                                              torch.from_numpy(ref).to(dtype).float().numpy())
            else:
                np.testing.assert_array_equal(got.numpy(), ref)
            if kind == "int8":
                assert got.min() >= (0 if relu else -127) and got.max() <= 127
    assert int8_conv.KERNEL.launches == launches  # the CPU never launches the kernel


@pytest.mark.parametrize("groups,cin,stride,dilation", [(32, 256, 2, 1), (32, 1024, 1, 4),
                                                        (1, 64, 2, 1)])
def test_matches_jax_int8_conv_and_epilogue(groups, cin, stride, dilation):
    """The JAX package's int32 conv (``quant._conv`` with
    ``preferred_element_type=int32``) on the tile-diagonal kernel, and its
    requantize expression, eagerly on the CPU."""
    from vision_semantic_segmentation_tpu_torch.models.quant import pack_tile_diag

    rng = np.random.default_rng(groups + cin)
    x, wt = _inputs(rng, 1, 9, 10, cin, cin, groups)
    oihw = np.ascontiguousarray(wt.transpose(0, 3, 1, 2))
    dense = pack_tile_diag(oihw, groups) if groups > 1 else oihw.transpose(2, 3, 1, 0)[:, :, None]
    tiles, cin_t = dense.shape[2], dense.shape[3]
    pad = ((dilation, dilation), (dilation, dilation))
    outs = [j_quant._conv(jnp.asarray(x[..., t * cin_t:(t + 1) * cin_t]), jnp.asarray(dense[:, :, t]),
                          (stride, stride), pad, (dilation, dilation), prefer=jnp.int32)
            for t in range(tiles)]
    j_acc = np.concatenate([np.asarray(o) for o in outs], axis=-1)
    scale = (rng.uniform(0.5, 2.0, cin) / np.abs(j_acc).max() * 60).astype(np.float32)
    shift = rng.uniform(-3, 3, cin).astype(np.float32)
    j_int8 = np.asarray(jnp.clip(jnp.round(jnp.asarray(j_acc).astype(jnp.float32) * scale + shift),
                                 0, 127).astype(jnp.int8))
    got = int8_conv.int8_conv3x3(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(scale),
                                 torch.from_numpy(shift), stride, dilation, dilation, groups,
                                 torch.int8, relu=True)
    acc = int8_conv.int8_conv3x3_acc_plain(torch.from_numpy(x), torch.from_numpy(wt), stride,
                                           dilation, dilation, groups)
    np.testing.assert_array_equal(acc.numpy(), j_acc)
    np.testing.assert_array_equal(got.numpy(), j_int8)


def test_epilogue_rounds_half_to_even():
    acc = torch.tensor([[1, 3, 5, -1, -3, 255, -255, 0]], dtype=torch.int32)
    scale = torch.full((8,), 0.5)
    shift = torch.zeros(8)
    got = int8_conv.epilogue(acc, scale, shift, torch.int8, relu=False)
    assert got.tolist() == [[0, 2, 2, 0, -2, 127, -127, 0]]
    assert int8_conv.epilogue(acc, scale, shift, torch.int8, relu=True).min() == 0


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros((1, 5, 5, 8), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="int8"):
        int8_conv.int8_conv3x3(x.float(), w, s, s)
    with pytest.raises(ValueError, match="Cout, 3, 3"):
        int8_conv.int8_conv3x3(x, w, s, s, groups=2)
    with pytest.raises(ValueError, match="scale"):
        int8_conv.int8_conv3x3(x, w, s[:4], s)
    with pytest.raises(ValueError, match="out_dtype"):
        int8_conv.int8_conv3x3(x, w, s, s, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="empty"):
        int8_conv.int8_conv3x3(x[:, :2, :2], w, s, s, padding=0)


@pytest.mark.parametrize("m", [5, 16, 17, 300])
def test_int8_matmul_matches_numpy(m):
    """The 1x1 sites' product (``torch._int_mm``, rows padded past 16)."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, 64)).astype(np.int8)
    w = rng.integers(-127, 128, (24, 64)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (m, 24)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.T.astype(np.int64))
