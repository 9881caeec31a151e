"""GroupNorm + affine + activation over NCHW, computed in f32.

Plain torch ops, as the JAX package's default path runs XLA here (its Pallas
GroupNorm kernels are off by default); the hand-written kernel comes in a
later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               act: Optional[str] = "silu") -> torch.Tensor:
    """NCHW group norm + optional SiLU in f32, cast back to x's dtype
    (`group_norm_reference` semantics). `act` is "silu" or None, the two the
    SD path uses."""
    if act not in (None, "silu"):
        raise ValueError(f"Unsupported activation {act!r}")
    out = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)
