"""Unconditional UNet (the DDPM and LDM denoisers) in torch, NCHW: the port
of `models/unet2d.py` with diffusers' `UNet2DModel` key names (attention
under the current `to_q/to_k/to_v/to_out.0` names; `models/port.py` also
reads the legacy `query/key/value/proj_attn` ones).

DDPM (google/ddpm-celebahq-256): `flip_sin_to_cos=False`, `freq_shift=1`,
`downsample_padding=0` (the asymmetric pad) and single-head attention. LDM
(CompVis/ldm-celebahq-256 `unet`): `flip_sin_to_cos=True`, `freq_shift=0`,
`downsample_padding=1`, heads of dim 32."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..ops.conv import Conv3x3
from .layers import (
    AttentionBlock2D,
    Downsample2D,
    GroupNormLayer,
    ResnetBlock2D,
    TimeEmbedding,
    Upsample2D,
    timestep_embedding,
)
from .unet2d_cond import _Block


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    sample_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "DownBlock2D", "DownBlock2D", "DownBlock2D", "AttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "AttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: Optional[int] = None  # None: one head over all channels
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    downsample_padding: int = 0  # 0: DDPM's asymmetric (0, 1, 0, 1) pad
    flip_sin_to_cos: bool = False
    freq_shift: float = 1.0
    add_mid_attention: bool = True
    # Fold each ResnetBlock's GroupNorm(+temb)+SiLU into its conv where the
    # shape allows (`ops.fused_conv`): the JAX package's DIE_TPU_FUSED_CONV=1.
    fused_conv: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


# Small config for tests: the whole architecture at tiny channel counts.
TINY_UNET2D = UNet2DConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    norm_num_groups=8,
)

DDPM_CELEBAHQ_256 = UNet2DConfig()  # google/ddpm-celebahq-256

LDM_CELEBAHQ_256_UNET = UNet2DConfig(  # CompVis/ldm-celebahq-256 `unet`
    sample_size=64,
    in_channels=3,
    out_channels=3,
    block_out_channels=(224, 448, 672, 896),
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=2,
    attention_head_dim=32,
    downsample_padding=1,
    flip_sin_to_cos=True,
    freq_shift=0.0,
)


class UNet2D(nn.Module):
    """DDPM / LDM UNet, NCHW. Built on `device` (None = CUDA, raising
    without it) with parameters in `dtype`; `forward` returns f32 eps.
    (`encoder_features` waits for ROADMAP Queue A item 16.)"""

    def __init__(self, config: UNet2DConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = cfg = config
        fk = dict(device=resolve_device(device), dtype=dtype)
        rk = dict(fk, fused_conv=cfg.fused_conv)  # ResnetBlock2D keywords
        g, eps, hd = cfg.norm_num_groups, cfg.norm_eps, cfg.attention_head_dim
        temb = cfg.time_embed_dim
        c0 = cfg.block_out_channels[0]
        self.time_embedding = TimeEmbedding(c0, temb, **fk)
        self.conv_in = Conv3x3(cfg.in_channels, c0, **fk)

        skips, ch, downs = [c0], c0, []
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb, g, eps, **rk))
                ch = out_ch
                if btype == "AttnDownBlock2D":
                    attns.append(AttentionBlock2D(ch, hd, g, eps, **fk))
                skips.append(ch)
            down = None
            if i < len(cfg.down_block_types) - 1:
                down = [Downsample2D(ch, ch, padding=cfg.downsample_padding, **fk)]
                skips.append(ch)
            downs.append(_Block(resnets, attns, downsamplers=down))
        self.down_blocks = nn.ModuleList(downs)

        mid_attn = [AttentionBlock2D(ch, hd, g, eps, **fk)] if cfg.add_mid_attention else None
        self.mid_block = _Block(
            [ResnetBlock2D(ch, ch, temb, g, eps, **rk), ResnetBlock2D(ch, ch, temb, g, eps, **rk)],
            mid_attn)

        ups = []
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = list(reversed(cfg.block_out_channels))[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skips.pop(), out_ch, temb, g, eps, **rk))
                ch = out_ch
                if btype == "AttnUpBlock2D":
                    attns.append(AttentionBlock2D(ch, hd, g, eps, **fk))
            up = [Upsample2D(ch, ch, **fk)] if i < len(cfg.up_block_types) - 1 else None
            ups.append(_Block(resnets, attns, upsamplers=up))
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = GroupNormLayer(ch, g, eps, "silu", **fk)
        self.conv_out = Conv3x3(ch, cfg.out_channels, **fk)

    def forward(self, sample: torch.Tensor, timesteps) -> torch.Tensor:
        """sample (B, C, H, W); timesteps a scalar or (B,)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(np.asarray(timesteps) if not torch.is_tensor(timesteps)
                            else timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(sample.shape[0])
        t_emb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                   cfg.freq_shift)
        temb = self.time_embedding(t_emb)

        h = self.conv_in(sample.to(dtype))
        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, temb)
        if hasattr(self.mid_block, "attentions"):
            h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h)).float()
