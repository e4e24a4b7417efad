"""Bytes the measured kernels need, as plain functions of shape.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the least time is those bytes over the
card's memory bandwidth.  At (1, 180, 240, 2048) bf16 and a 5 x 2000 x 2000
grid these give the byte bounds of the port's kernel table: K4 211.3 us,
K3 105.7 us, K2 71.6 us at 3.35 TB/s.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12


def k4_bytes(n: int, h: int, w: int, c: int, branches: int, itemsize: int) -> int:
    """ASPP's depthwise 3x3 branches over one NHWC input: the input read
    once, one output a branch written, the (branches, 9, C) f32 taps read."""
    return n * h * w * c * itemsize * (1 + branches) + branches * 9 * c * 4


def k3_bytes(n: int, h: int, w: int, c: int, itemsize: int) -> int:
    """One depthwise 3x3: input and output once, the (9, C) f32 taps."""
    return 2 * n * h * w * c * itemsize + 9 * c * 4


def k2_bytes(c: int, h: int, w: int) -> int:
    """The evidence fold ``grid += E @ obs`` on (C, H, W) f32: grid read and
    written, observations read."""
    return 3 * c * h * w * 4


def roofline_pct(bytes_needed: float, device_seconds: float) -> float:
    """The least time the bytes take, as a share of the measured time, in %."""
    return 100.0 * bytes_needed / H100_BYTES_PER_S / device_seconds
