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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, ptr, uses_plain

KERNEL = CudaKernel(
    "int8_conv3x3", "int8_conv.cu", "int8_conv3x3",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13,
)
_OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def conv_out_hw(h: int, w: int, stride: int, padding: int, dilation: int) -> Tuple[int, int]:
    """Output size of a 3x3 conv."""
    return ((h + 2 * padding - 2 * dilation - 1) // stride + 1,
            (w + 2 * padding - 2 * dilation - 1) // stride + 1)


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
    if (cin // groups) % 4 or (cout // groups) % 4:
        raise ValueError(f"int8_conv3x3 needs Cin / groups and Cout / groups multiples of 4, "
                         f"got {cin // groups} and {cout // groups}")
    if not all(t.is_contiguous() for t in (x, w, scale, shift)) or \
            x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8_conv3x3 needs contiguous x, w, scale, shift; x and w 16-byte aligned")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x.device)
    KERNEL.launch(ptr(x), ptr(w), ptr(scale), ptr(shift), ptr(out), n, h, wd, cin, ho, wo,
                  cout, groups, stride, padding, dilation, _OUT_KIND[out_dtype], int(relu))
    return out
