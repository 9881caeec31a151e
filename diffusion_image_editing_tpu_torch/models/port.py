"""Weights: Flax params -> torch state dicts, and HF-layout checkpoint
directories -> the port's modules.

`state_dict_from_jax` is the inverse of the JAX package's `port_state_dict`
(diffusers or torch state dict -> Flax params) for the kinds this port has:
`"unet_cond"` (UNet2DCondition), `"unet2d"` (UNet2D), `"vae"`
(AutoencoderKL) and `"vq"` (VQModel), all under the modern attention names;
`"clip_text"` (CLIPTextEncoder, transformers' names); `"bisenet"` (BiSeNet)
and `"resnet50"` (the anyGAN ResNet50), from Flax `{"params",
"batch_stats"}` to the torchvision-style checkpoints' keys; `"lpips"`
(`evals.LPIPS`, torchvision's VGG16 and lpips' lin names). Conv kernels go
HWIO -> OIHW, Dense kernels (in, out) -> (out, in); scales and biases stay.
`port_vgg16_lpips` maps the published torchvision VGG16 and lpips lin
files onto `evals.LPIPS`.

`load_checkpoint_dir(model_dir, kind)` is the port of the JAX package's
checkpoint-directory loader: config.json + `.safetensors` (one file, or
shards listed by a `*.safetensors.index.json`) or `.bin`/`.pt`/`.pth`,
built into the module of the config and loaded strictly, the file's tensors
cast to the module's dtype. The port's modules carry the checkpoints' own
names, so the only translations are the legacy attention names
(`query/key/value/proj_attn`, of the UNet2D and both autoencoders) and
transformers' `position_ids` buffer. `save_checkpoint_dir` writes a module
in that layout (`.bin`). `safetensors` is imported only for its files.
`load_bisenet_checkpoint` reads the face-parsing BiSeNet's `.pth` file and
`load_anygan_checkpoint` the anyGAN ResNet-50's.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

KINDS = ("unet_cond", "unet2d", "vae", "vq", "clip_text", "bisenet", "resnet50", "lpips",
         "abn_blocks")

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
    (r"^quantize/embedding$", "quantize.embedding.weight"),
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


def _torchvision_state_dict(variables: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """Flax BiSeNet or ResNet50 `{"params", "batch_stats"}` -> the port's
    torchvision-style keys. A NormAct's inner `bn` (BatchNorm) or `abn`
    (FusedABNorm) level drops: `.../bn1/bn/scale` and `.../bn1/abn/weight`
    -> `...bn1.weight`, `mean`/`var` -> `running_mean`/`running_var`; a
    BatchNorm also gets the `num_batches_tracked` buffer (0) that torch's
    checkpoint keys carry. Dense and conv biases keep their name."""
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
            elif leaf == "bias" and coll == "params":
                name = "bias"
            else:
                raise ValueError(f"unexpected {kind} variable {coll}/{'/'.join(path)}")
            out[".".join(_bisenet_module(tuple(mod)) + (name,))] = torch.tensor(w)
    return out


def _abn_blocks_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `models/extra_blocks.py` `{"params", "batch_stats"}` (one level of
    modules: convs and FusedABNorms) -> `models.extra_blocks`' keys: `kernel`
    -> `weight` (OIHW), an ABN's `mean`/`var` -> `running_mean`/`running_var`,
    `weight` and `bias` as they are."""
    leaves = {"kernel": "weight", "weight": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
    out = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            *mod, leaf = path
            if leaf not in leaves or len(mod) != 1:
                raise ValueError(f"unexpected abn_blocks variable {coll}/{'/'.join(path)}")
            w = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                w = _to_torch_layout(path, w)
            out[f"{mod[0]}.{leaves[leaf]}"] = torch.tensor(w)
    return out


def clip_key(path: Tuple[str, ...]) -> str:
    """The transformers key of one Flax `CLIPTextEncoder` parameter path
    (the inverse of the JAX package's `_translate_clip_key`)."""
    leaf = {"embedding": "weight", "kernel": "weight", "scale": "weight", "bias": "bias"}
    *mod, name = path
    if mod[0] in ("token_embedding", "position_embedding"):
        return f"text_model.embeddings.{mod[0]}.weight"
    if mod[0] == "final_layer_norm":
        return f"text_model.final_layer_norm.{leaf[name]}"
    layer = re.fullmatch(r"layer_(\d+)", mod[0]).group(1)
    rest = ["mlp"] + mod[1:] if mod[1] in ("fc1", "fc2") else mod[1:]
    return f"text_model.encoder.layers.{layer}.{'.'.join(rest)}.{leaf[name]}"


def state_dict_from_jax(params: Mapping[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, with or without the top-level
    'params' key; for "bisenet" and "resnet50" the variables with their
    'batch_stats') -> the port's state dict for `kind` in KINDS."""
    if kind not in KINDS:
        raise ValueError(f"Unknown kind {kind!r}; choose from {KINDS}")
    if kind in ("bisenet", "resnet50"):
        return _torchvision_state_dict(params, kind)
    if kind == "abn_blocks":
        return _abn_blocks_state_dict(params)
    if "params" in params:
        params = params["params"]
    if kind == "lpips":
        return _lpips_from_jax(params)
    key = clip_key if kind == "clip_text" else torch_key
    out = {}
    for path, value in _flatten(params):
        w = _to_torch_layout(path, np.asarray(value, dtype=np.float32))
        out[key(path)] = torch.tensor(w)
    return out


def _lpips_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LPIPS params ({"vgg": {"conv_i": {kernel, bias}}, "lin_i": (C,)},
    without the heads for `use_lin=False`) -> `evals.LPIPS`'s keys."""
    from ..evals.lpips import conv_positions

    out = {}
    for i, p in enumerate(conv_positions()):
        conv = params["vgg"][f"conv_{i}"]
        out[f"vgg.features.{p}.weight"] = torch.tensor(
            _to_torch_layout(("kernel",), np.asarray(conv["kernel"], np.float32)))
        out[f"vgg.features.{p}.bias"] = torch.tensor(np.asarray(conv["bias"], np.float32))
    for i in range(5):
        if f"lin_{i}" in params:
            w = np.asarray(params[f"lin_{i}"], np.float32)
            out[f"lin{i}.model.1.weight"] = torch.tensor(w.reshape(1, -1, 1, 1))
    return out


def port_vgg16_lpips(vgg_state_dict: Mapping[str, Any],
                     lpips_state_dict: Optional[Mapping[str, Any]] = None,
                     ) -> Dict[str, torch.Tensor]:
    """torchvision's VGG16 state dict (`features.*`; its classifier is not
    used) and lpips' lin heads (`lin{i}.model.1.weight`) -> the state dict of
    `evals.LPIPS`, as the JAX package's `port_vgg16_lpips`. Without lin heads
    each channel weighs 1/C."""
    from ..evals.lpips import TAP_AFTER_CONV, conv_positions

    positions = conv_positions()
    out = {}
    for p in positions:
        for leaf in ("weight", "bias"):
            out[f"vgg.features.{p}.{leaf}"] = torch.as_tensor(
                np.asarray(vgg_state_dict[f"features.{p}.{leaf}"], np.float32))
    for i, conv in enumerate(TAP_AFTER_CONV):
        key = f"lin{i}.model.1.weight"
        if lpips_state_dict is not None:
            w = np.asarray(lpips_state_dict[key], np.float32)
        else:
            c = out[f"vgg.features.{positions[conv]}.weight"].shape[0]
            w = np.full((c,), 1.0 / c, np.float32)
        out[key] = torch.as_tensor(w.reshape(1, -1, 1, 1))
    return out


# ---------------------------------------------------------------------------
# Checkpoint directories (HF layout: config.json + weights)
# ---------------------------------------------------------------------------

LOADER_KINDS = ("unet2d", "unet2d_cond", "vae", "vq", "clip_text")  # the JAX loader's names
_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def load_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """The flat state dict of one component directory, on the CPU. Sharded
    safetensors follow their index (every shard it lists); otherwise every
    `.safetensors` file is merged; else the first `.bin`/`.pt`/`.pth`, with
    an optional top-level "state_dict"."""
    names = sorted(os.listdir(model_dir))
    st_files = [n for n in names if n.endswith(".safetensors")]
    if st_files:
        from safetensors.torch import load_file

        index = [n for n in names if n.endswith(".safetensors.index.json")]
        if index:
            with open(os.path.join(model_dir, index[0])) as f:
                st_files = sorted(set(json.load(f)["weight_map"].values()))
        merged: Dict[str, torch.Tensor] = {}
        for n in st_files:
            merged.update(load_file(os.path.join(model_dir, n)))
        return merged
    for name in names:
        if name.endswith((".bin", ".pt", ".pth")):
            sd = torch.load(os.path.join(model_dir, name), map_location="cpu",
                            weights_only=True)
            return sd["state_dict"] if "state_dict" in sd else sd
    raise FileNotFoundError(f"No weights found in {model_dir}")


def unet2d_config_from_json(cfg: Dict[str, Any]):
    from .unet2d import UNet2DConfig

    return UNet2DConfig(
        sample_size=cfg["sample_size"],
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        attention_head_dim=cfg.get("attention_head_dim"),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-6),
        downsample_padding=cfg.get("downsample_padding", 1),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", False),
        freq_shift=cfg.get("freq_shift", 1),
        add_mid_attention=cfg.get("add_attention", True),
    )


def unet2d_cond_config_from_json(cfg: Dict[str, Any]):
    from .unet2d_cond import UNet2DConditionConfig

    return UNet2DConditionConfig(
        sample_size=cfg["sample_size"],
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        attention_head_dim=cfg.get("attention_head_dim", 8),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
    )


def vae_config_from_json(cfg: Dict[str, Any], vq: bool = False):
    """The KL autoencoder's config, or with `vq` the VQ autoencoder's."""
    from .vae import AutoencoderConfig

    return AutoencoderConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        sample_size=cfg.get("sample_size", 512),
        scaling_factor=cfg.get("scaling_factor", 1.0 if vq else 0.18215),
        double_z=not vq,
        num_vq_embeddings=cfg.get("num_vq_embeddings", 8192),
        vq_embed_dim=cfg.get("vq_embed_dim") or cfg.get("latent_channels", 3),
    )


def clip_text_config_from_json(cfg: Dict[str, Any]):
    from .clip_text import CLIPTextConfig

    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size", 3072),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
    )


def _checkpoint_key(key: str, kind: str):
    """A checkpoint key under the port's name, or None for a buffer the port
    does not keep."""
    if kind in ("unet2d", "vae", "vq"):
        m = re.match(r"(.*\.attentions\.\d+\.)(query|key|value|proj_attn)\.(weight|bias)$", key)
        if m:
            key = f"{m.group(1)}{_LEGACY_ATTN[m.group(2)]}.{m.group(3)}"
    elif kind == "clip_text" and key.endswith("embeddings.position_ids"):
        return None
    return key


def load_checkpoint_dir(model_dir: str, kind: str, device=None,
                        dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build `kind`'s module from `model_dir`/config.json on `device` (None =
    CUDA, raising without it) in `dtype`, and load the directory's weights
    into it strictly: a checkpoint key the module lacks, or a module key the
    checkpoint lacks, raises ValueError. The UNet2D's and the autoencoders'
    attention weights load under either naming."""
    if kind not in LOADER_KINDS:
        raise ValueError(f"Unknown kind {kind!r}; choose from {LOADER_KINDS}")
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    weights = load_weights(model_dir)
    if kind == "unet2d":
        from .unet2d import UNet2D

        module = UNet2D(unet2d_config_from_json(cfg), device=device, dtype=dtype)
    elif kind == "unet2d_cond":
        from .unet2d_cond import UNet2DCondition

        module = UNet2DCondition(unet2d_cond_config_from_json(cfg), device=device, dtype=dtype)
    elif kind == "vae":
        from .vae import AutoencoderKL

        module = AutoencoderKL(vae_config_from_json(cfg), device=device, dtype=dtype)
    elif kind == "vq":
        from .vae import VQModel

        module = VQModel(vae_config_from_json(cfg, vq=True), device=device, dtype=dtype)
    else:
        from .clip_text import CLIPTextEncoder

        module = CLIPTextEncoder(clip_text_config_from_json(cfg), device=device, dtype=dtype)
    state = {}
    for key, w in weights.items():
        name = _checkpoint_key(key, kind)
        if name is not None:
            state[name] = w
    own = module.state_dict()
    unmapped = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if unmapped or missing:
        raise ValueError(f"checkpoint {model_dir} ({kind}): unmapped keys {unmapped[:10]}, "
                         f"missing keys {missing[:10]}")
    module.load_state_dict(state, strict=True)
    return module


def config_to_json(config) -> Dict[str, Any]:
    """A module config under the HF config.json names the loader reads."""
    from .clip_text import CLIPTextConfig
    from .unet2d import UNet2DConfig
    from .unet2d_cond import UNet2DConditionConfig
    from .vae import AutoencoderConfig

    if isinstance(config, CLIPTextConfig):
        return dict(vocab_size=config.vocab_size, hidden_size=config.hidden_size,
                    num_hidden_layers=config.num_layers, num_attention_heads=config.num_heads,
                    intermediate_size=config.intermediate_size,
                    max_position_embeddings=config.max_position_embeddings,
                    hidden_act=config.hidden_act)
    if isinstance(config, UNet2DConfig):
        keys = ("sample_size", "in_channels", "out_channels", "block_out_channels",
                "down_block_types", "up_block_types", "layers_per_block", "attention_head_dim",
                "norm_num_groups", "norm_eps", "downsample_padding", "flip_sin_to_cos",
                "freq_shift")
        extra = {"add_attention": config.add_mid_attention}
    elif isinstance(config, UNet2DConditionConfig):
        keys = ("sample_size", "in_channels", "out_channels", "block_out_channels",
                "down_block_types", "up_block_types", "layers_per_block", "attention_head_dim",
                "cross_attention_dim", "norm_num_groups", "norm_eps", "flip_sin_to_cos",
                "freq_shift")
        extra = {}
    elif isinstance(config, AutoencoderConfig):
        keys = ("in_channels", "out_channels", "latent_channels", "block_out_channels",
                "layers_per_block", "norm_num_groups", "sample_size", "scaling_factor")
        keys += () if config.double_z else ("num_vq_embeddings", "vq_embed_dim")
        extra = {}
    else:
        raise ValueError(f"no config.json form for {type(config).__name__}")
    values = dict({k: getattr(config, k) for k in keys}, **extra)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in values.items()}


def save_checkpoint_dir(module: nn.Module, model_dir: str,
                        legacy_attention_names: bool = False) -> int:
    """Write `module` as an HF-layout component directory: config.json and
    its weights as they are (dtype kept) in `pytorch_model.bin`. With
    `legacy_attention_names`, the attention weights of a UNet2D or an
    autoencoder go under the old `query/key/value/proj_attn` names. Returns
    the bytes of the weights."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_to_json(module.config), f, indent=1)
    legacy = {v: k for k, v in _LEGACY_ATTN.items()}
    state = {}
    for key, w in module.state_dict().items():
        if legacy_attention_names:
            m = re.match(r"(.*\.attentions\.\d+\.)(to_q|to_k|to_v|to_out\.0)\.(weight|bias)$",
                         key)
            if m:
                key = f"{m.group(1)}{legacy[m.group(2)]}.{m.group(3)}"
        state[key] = w.detach().cpu().contiguous()
    torch.save(state, os.path.join(model_dir, "pytorch_model.bin"))
    return sum(w.numel() * w.element_size() for w in state.values())


def load_bisenet_checkpoint(path: str, device=None) -> nn.Module:
    """The face-parsing BiSeNet checkpoint (`79999_iter.pth` of
    zllrunning/face-parsing.PyTorch, or any state dict under its keys,
    optionally inside "state_dict" and behind `module.`) as a
    `BiSeNet(norm="bn")` on `device` (None = CUDA, raising without it),
    loaded strictly; its classes and width are read from the weights."""
    from ..core.device import resolve_device
    from .bisenet import BiSeNet

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    module = BiSeNet(n_classes=sd["conv_out.conv_out.weight"].shape[0], norm="bn",
                     width=sd["cp.resnet.conv1.weight"].shape[0],
                     device=resolve_device(device))
    module.load_state_dict(sd, strict=True)
    return module


def load_anygan_checkpoint(path: str, device=None) -> nn.Module:
    """The MIT anycost-gan attribute predictor's `.pth` (a torchvision
    ResNet-50 with fc -> 80 logits, or any state dict under its keys,
    optionally inside "state_dict") as a `ResNet50(norm="bn")` on `device`
    (None = CUDA, raising without it), loaded strictly, in eval mode; its
    width is read from the weights."""
    from ..core.device import resolve_device
    from .resnet import ResNet50

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    module = ResNet50(num_outputs=sd["fc.weight"].shape[0], norm="bn",
                      width=sd["conv1.weight"].shape[0], device=resolve_device(device))
    module.load_state_dict(sd, strict=True)
    return module.eval()
