"""Weights carried across from the JAX package: Flax params -> torch state dict.

The inverse of the JAX package's `models/port.py` (diffusers state dict ->
Flax params) for the kinds this port has: `"unet_cond"` (UNet2DCondition)
and `"vae"` (AutoencoderKL, modern attention names). Conv kernels go
HWIO -> OIHW, Dense kernels (in, out) -> (out, in); scales and biases stay.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

KINDS = ("unet_cond", "vae")

# (pattern, replacement) applied in order to the '/'-joined Flax path.
_PREFIX_RULES = (
    (r"^(encoder|decoder)/", r"\1."),
    (r"(^|\.)(down|up)_(\d+)_resnet_(\d+)/", r"\1\2_blocks.\3.resnets.\4."),
    (r"(^|\.)(down|up)_(\d+)_attn_(\d+)/", r"\1\2_blocks.\3.attentions.\4."),
    (r"(^|\.)mid_resnet_(\d+)/", r"\1mid_block.resnets.\2."),
    (r"(^|\.)mid_attn/", r"\1mid_block.attentions.0."),
    (r"(^|\.)down_(\d+)_downsample/", r"\1down_blocks.\2.downsamplers.0."),
    (r"(^|\.)up_(\d+)_upsample/", r"\1up_blocks.\2.upsamplers.0."),
    (r"block_(\d+)/", r"transformer_blocks.\1."),
    (r"ff/proj/", "ff.net.0.proj."),
    (r"ff/out/", "ff.net.2."),
    (r"to_out/", "to_out.0."),
    (r"(^|\.)query/", r"\1to_q."),
    (r"(^|\.)key/", r"\1to_k."),
    (r"(^|\.)value/", r"\1to_v."),
    (r"(^|\.)proj_attn/", r"\1to_out.0."),
    (r"(norm1|norm2|group_norm)_(scale|bias)$", r"\1/\2"),
)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def torch_key(path: Tuple[str, ...]) -> str:
    """The diffusers key of one Flax parameter path."""
    name = "/".join(path)
    for pattern, repl in _PREFIX_RULES:
        name = re.sub(pattern, repl, name)
    name = re.sub(r"[/.](kernel|scale)$", ".weight", name)
    return name.replace("/", ".")


def _to_torch_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return w
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW
    if w.ndim == 2:
        return np.transpose(w)  # (in, out) -> (out, in)
    raise ValueError(f"unexpected kernel rank {w.ndim} at {'/'.join(path)}")


def state_dict_from_jax(params: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, with or without the top-level
    'params' key) -> the port's state dict for `kind` in KINDS."""
    if kind not in KINDS:
        raise ValueError(f"Unknown kind {kind!r}; choose from {KINDS}")
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        w = _to_torch_layout(path, np.asarray(value, dtype=np.float32))
        out[torch_key(path)] = torch.tensor(w)
    return out
