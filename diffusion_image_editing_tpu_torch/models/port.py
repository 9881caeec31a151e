"""Weights carried across from the JAX package: Flax params -> torch state dict.

The inverse of the JAX package's `models/port.py` (diffusers or torch
state dict -> Flax params) for the kinds this port has: `"unet_cond"`
(UNet2DCondition), `"vae"` (AutoencoderKL, modern attention names) and
`"bisenet"` (BiSeNet, from Flax `{"params", "batch_stats"}`, to the
face-parsing checkpoint's keys). Conv kernels go HWIO -> OIHW, Dense kernels
(in, out) -> (out, in); scales and biases stay.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

KINDS = ("unet_cond", "vae", "bisenet")

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


_NORM_LEAVES = {"scale": "weight", "weight": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def _bisenet_module(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """`layer1_0` -> `layer1.0`; `downsample_conv`/`_bn` -> `downsample.0`/`.1`."""
    out = []
    for name in path:
        layer = re.fullmatch(r"(layer\d+)_(\d+)", name)
        if layer:
            out += layer.groups()
        elif name in ("downsample_conv", "downsample_bn"):
            out += ["downsample", "0" if name == "downsample_conv" else "1"]
        else:
            out.append(name)
    return tuple(out)


def _bisenet_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax BiSeNet `{"params", "batch_stats"}` -> the port's BiSeNet keys.
    A NormAct's inner `bn` (BatchNorm) or `abn` (FusedABNorm) level drops:
    `.../bn1/bn/scale` and `.../bn1/abn/weight` -> `...bn1.weight`,
    `mean`/`var` -> `running_mean`/`running_var`; a BatchNorm also gets the
    `num_batches_tracked` buffer (0) that torch's checkpoint keys carry."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            w = np.asarray(value, dtype=np.float32)
            *mod, leaf = path
            if mod and mod[-1] in ("bn", "abn") and leaf in _NORM_LEAVES:
                if mod[-1] == "bn" and leaf == "mean":
                    key = ".".join(_bisenet_module(tuple(mod[:-1])) + ("num_batches_tracked",))
                    out[key] = torch.zeros((), dtype=torch.long)
                mod, name = mod[:-1], _NORM_LEAVES[leaf]
            elif leaf == "kernel":
                w, name = _to_torch_layout(path, w), "weight"
            else:
                raise ValueError(f"unexpected BiSeNet variable {coll}/{'/'.join(path)}")
            out[".".join(_bisenet_module(tuple(mod)) + (name,))] = torch.tensor(w)
    return out


def state_dict_from_jax(params: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, with or without the top-level
    'params' key; for "bisenet" the variables with their 'batch_stats')
    -> the port's state dict for `kind` in KINDS."""
    if kind not in KINDS:
        raise ValueError(f"Unknown kind {kind!r}; choose from {KINDS}")
    if kind == "bisenet":
        return _bisenet_state_dict(params)
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        w = _to_torch_layout(path, np.asarray(value, dtype=np.float32))
        out[torch_key(path)] = torch.tensor(w)
    return out
