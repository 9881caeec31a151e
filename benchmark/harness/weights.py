"""Seeded weights, made on the device in a few large draws.

Every tensor of a module's state dict is filled from one normal draw per
dtype (keys in sorted order), scaled by the tensor's role as read from its
key and shape, so that the program's module and the reference's, which
share diffusers' key names, receive the same values: the program in the
dtype it serves, the reference the same numbers upcast to float32.

- a weight of rank >= 2: std 1 / sqrt(3 fan_in), as PyTorch's default
  init (a VQ codebook: std 1);
- the bias beside it: the same std; a norm's scale 1 + 0.1 n, its shift 0.1 n;
- BatchNorm running statistics: mean 0.1 n, variance exp(0.1 n).
"""

from __future__ import annotations

import zlib
from typing import Dict

import torch
import torch.nn as nn

MASK63 = (1 << 63) - 1


def mix_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) & MASK63


def _role(key: str, shape, state: Dict[str, torch.Tensor]):
    """(std, mean) of the tensor `key`, or None for a counter."""
    if key.endswith("num_batches_tracked"):
        return None
    if key.endswith("running_mean"):
        return 0.1, 0.0
    if key.endswith("running_var"):
        return "lognormal", 0.0
    if len(shape) >= 2:
        if "embedding" in key:
            return 1.0, 0.0
        fan_in = 1
        for d in shape[1:]:
            fan_in *= d
        return (3.0 * fan_in) ** -0.5, 0.0
    sibling = key[: -len("bias")] + "weight" if key.endswith("bias") else None
    if sibling is not None and sibling in state and state[sibling].dim() >= 2:
        return _role(sibling, tuple(state[sibling].shape), state)
    return (0.1, 1.0) if key.endswith("weight") else (0.1, 0.0)


@torch.no_grad()
def fill_seeded(module: nn.Module, seed: int, tag: str, draw_dtype: torch.dtype,
                device) -> None:
    """Overwrite every parameter and buffer of `module` with the seeded
    values: one draw of `draw_dtype` on `device` for all of them, each
    value computed in `draw_dtype` and then cast to the tensor's own dtype
    (exact when that is wider)."""
    state = module.state_dict(keep_vars=True)
    keys = sorted(state)
    sizes = [state[k].numel() if _role(k, tuple(state[k].shape), state) else 0 for k in keys]
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, tag))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=draw_dtype)
    off = 0
    for key, n in zip(keys, sizes):
        t = state[key]
        role = _role(key, tuple(t.shape), state)
        if role is None:
            t.data.zero_()
            continue
        z = buf[off:off + n].view(t.shape)
        off += n
        std, mean = role
        val = torch.exp(z * 0.1) if std == "lognormal" else z * std + mean
        t.data.copy_(val)
    del buf


def program_module(ctor, device) -> nn.Module:
    """A module of the program built on the meta device and given empty
    storage on `device`: no default initialisation runs, since
    `fill_seeded` writes every tensor."""
    module = ctor(torch.device("meta"))
    return module.to_empty(device=device)
