"""The correctness check's control precision: the reference with every
matrix product and convolution, forward and backward, computed on float8
(e4m3) operands, each operand scaled by its own largest magnitude (per
tensor) before the cast, the products accumulated in float32. The
configurations serve bfloat16; float8 is the precision below it.

The mode sits under autograd (a dispatch mode), so it sees the products
that a backward runs (the gradient's matrix products and
`convolution_backward`) as well as the forward's; a guidance gradient is
then computed in float8 like the rest."""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

E4M3_MAX = 448.0
aten = torch.ops.aten
# the positions of each product's two (three for a convolution's backward) operands
_OPERANDS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2),
             aten.convolution: (0, 1), aten.convolution_backward: (0, 1, 2)}


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class FP8Products(TorchDispatchMode):
    """Inside the block, the operands of every matrix product and
    convolution, and of every convolution's backward, are rounded to
    float8 first. `calls` counts the rounded calls by operator."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        which = _OPERANDS.get(func.overloadpacket)
        if which is not None:
            self.calls[func.overloadpacket.__name__] += 1
            args = tuple(to_fp8(a) if i in which and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))
