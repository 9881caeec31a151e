"""SD's KL autoencoder in torch, NCHW: the port of `models/vae.py`
(`AutoencoderKL`; VQ comes later), with diffusers' key names and the modern
`to_q/to_k/to_v/to_out.0` attention naming.

`encode` returns the distribution mode (the latent mean); `decode` is
differentiable end to end, the path of the guidance gradient."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..ops.conv import Conv3x3
from .layers import AttentionBlock2D, Downsample2D, GroupNormLayer, ResnetBlock2D, Upsample2D
from .unet2d_cond import _Block


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
    double_z: bool = True  # KL: the encoder emits mean and log-variance
    mid_attention: bool = True
    # Fold each ResnetBlock's GroupNorm+SiLU into its conv where the shape
    # allows (`ops.fused_conv`): the JAX package's DIE_TPU_FUSED_CONV=1.
    fused_conv: bool = False


SD_VAE = AutoencoderConfig()  # CompVis/stable-diffusion-v1-4 `vae`

TINY_VAE = AutoencoderConfig(
    latent_channels=4,
    block_out_channels=(16, 32),
    layers_per_block=1,
    norm_num_groups=8,
    sample_size=32,
)


def _resnet_kw(cfg: AutoencoderConfig, fk: dict) -> dict:
    return dict(fk, fused_conv=cfg.fused_conv)


def _mid_block(cfg: AutoencoderConfig, ch: int, **fk) -> _Block:
    g, eps = cfg.norm_num_groups, cfg.norm_eps
    attns = [AttentionBlock2D(ch, None, g, eps, **fk)] if cfg.mid_attention else None
    return _Block([ResnetBlock2D(ch, ch, None, g, eps, **_resnet_kw(cfg, fk)),
                   ResnetBlock2D(ch, ch, None, g, eps, **_resnet_kw(cfg, fk))], attns)


def _run_mid(block: _Block, h: torch.Tensor) -> torch.Tensor:
    h = block.resnets[0](h)
    if hasattr(block, "attentions"):
        h = block.attentions[0](h)
    return block.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, **fk):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        ch = cfg.block_out_channels[0]
        self.conv_in = Conv3x3(cfg.in_channels, ch, **fk)
        downs = []
        for i, out_ch in enumerate(cfg.block_out_channels):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps, **_resnet_kw(cfg, fk)))
                ch = out_ch
            down = ([Downsample2D(ch, ch, padding=0, **fk)]
                    if i < len(cfg.block_out_channels) - 1 else None)
            downs.append(_Block(resnets, downsamplers=down))
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = _mid_block(cfg, ch, **fk)
        self.conv_norm_out = GroupNormLayer(ch, g, eps, "silu", **fk)
        self.conv_out = Conv3x3(ch, cfg.latent_channels * (2 if cfg.double_z else 1), **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, **fk):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        reversed_out = list(reversed(cfg.block_out_channels))
        ch = reversed_out[0]
        self.conv_in = Conv3x3(cfg.latent_channels, ch, **fk)
        self.mid_block = _mid_block(cfg, ch, **fk)
        ups = []
        for i, out_ch in enumerate(reversed_out):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps, **_resnet_kw(cfg, fk)))
                ch = out_ch
            up = [Upsample2D(ch, ch, **fk)] if i < len(reversed_out) - 1 else None
            ups.append(_Block(resnets, upsamplers=up))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNormLayer(ch, g, eps, "silu", **fk)
        self.conv_out = Conv3x3(ch, cfg.out_channels, **fk)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """KL autoencoder, NCHW. Built on `device` (None = CUDA, raising without
    it) with parameters in `dtype`."""

    def __init__(self, config: AutoencoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        fk = dict(device=resolve_device(device), dtype=dtype)
        zc = config.latent_channels
        self.encoder = Encoder(config, **fk)
        self.decoder = Decoder(config, **fk)
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1, **fk)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1, **fk)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        return moments.chunk(2, dim=1)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
