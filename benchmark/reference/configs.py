"""The reference models' configurations: plain records of the sizes in a
benchmark configuration file (`benchmark/configs/<name>.json`), with the
field names of the published diffusers `config.json` files they come from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {unknown}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = ()
    up_block_types: Tuple[str, ...] = ()
    layers_per_block: int = 2
    attention_head_dim: int = 8  # the number of heads (diffusers' naming)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_dict(cls, d: dict) -> "UNet2DConditionConfig":
        return _from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    sample_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = ()
    down_block_types: Tuple[str, ...] = ()
    up_block_types: Tuple[str, ...] = ()
    layers_per_block: int = 2
    attention_head_dim: Optional[int] = None  # None: one head over all channels
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    downsample_padding: int = 0
    flip_sin_to_cos: bool = False
    freq_shift: float = 1.0
    add_mid_attention: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def from_dict(cls, d: dict) -> "UNet2DConfig":
        return _from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    sample_size: int = 512
    scaling_factor: float = 0.18215
    double_z: bool = True
    num_vq_embeddings: int = 8192
    vq_embed_dim: int = 3
    mid_attention: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "AutoencoderConfig":
        return _from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class ResNet50Config:
    num_outputs: int = 80
    width: int = 64
    bn_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "ResNet50Config":
        return _from_dict(cls, d)
