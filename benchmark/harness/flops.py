"""The yardstick's arithmetic: published peaks, the analytic work of the
attention and GroupNorm calls (roofline bounds), and model FLOPs counted
on the plain reference modules.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W power
limit): 989e12 FLOP/s bf16 on the tensor cores, 67e12 FLOP/s float32 off
them, 3.35e12 bytes/s of HBM3.
"""

from __future__ import annotations

import math
from typing import Callable

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
GN_OPS_PER_ELEMENT = 8  # sum, sum of squares, normalise, affine, and the activation


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations or bytes, whichever
    binds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def attention_work(q_shape, k_shape, elem_bytes: int) -> tuple:
    """(FLOPs, bytes) of one forward attention, (B, S, H, D) operands: Q K^T
    and P V, 2 B H Sq Sk D each; Q, K, V read and O written once."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    flops = 4.0 * b * h * sq * sk * d
    nbytes = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * h * d)
    return flops, nbytes


def group_norm_work(x_shape, elem_bytes: int, channels: int) -> tuple:
    """(FLOPs, bytes) of one GroupNorm(+activation) forward: the input read
    and the output written once, the f32 scale and shift read once."""
    n = math.prod(x_shape)
    return GN_OPS_PER_ELEMENT * n, 2 * elem_bytes * n + 2 * 4 * channels


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs that `torch.utils.flop_counter` counts while `fn` runs (matrix
    products and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
