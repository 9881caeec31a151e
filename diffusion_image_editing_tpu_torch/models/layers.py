"""Shared NCHW building blocks of the UNet and the VAE: the port of
`models/layers.py`, with diffusers' parameter names so HF state dicts load
with `load_state_dict`. Every constructor takes torch factory keywords
(`device`, `dtype`); a block casts its input to its own weights' dtype, as
Flax modules with `dtype=` do."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.conv import Conv3x3
from ..ops.fused_conv import fused_conv_wanted, gn_silu_conv3x3
from ..ops.groupnorm import group_norm
from ..ops import split as spatial


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `Timesteps`), f32, (B, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimeEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 (diffusers `TimestepEmbedding`)."""

    def __init__(self, in_dim: int, dim: int, **factory):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, **factory)
        self.linear_2 = nn.Linear(dim, dim, **factory)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(t_emb.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


class GroupNormLayer(nn.Module):
    """GroupNorm(+activation) with `weight`/`bias` parameters, f32 inside."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-6,
                 act: Optional[str] = None, **factory):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels, **factory))
        self.bias = nn.Parameter(torch.zeros(num_channels, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


class ResnetBlock2D(nn.Module):
    """GroupNorm+SiLU -> conv -> (+temb) -> GroupNorm+SiLU -> conv, residual.

    With `fused_conv` (the JAX block under DIE_TPU_FUSED_CONV=1), a conv
    whose input shape passes `fused_conv_wanted` takes its GroupNorm+SiLU as
    a per-(batch, channel) prologue (`ops.fused_conv`): conv1 takes (A1, B1)
    of norm1, conv2 (A2, B2) of norm2 with the temb projection folded in as
    the shift, so no h + temb tensor is made. Other shapes, and the block
    without `fused_conv`, run the unfused branch. The parameters are the
    same either way. Under a spatial split the gate reads the whole map's
    rows, so the same convs fuse split and whole."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 norm_num_groups: int = 32, norm_eps: float = 1e-6,
                 output_scale_factor: float = 1.0, fused_conv: bool = False, **factory):
        super().__init__()
        self.output_scale_factor = output_scale_factor
        self.fused_conv = fused_conv
        self.norm1 = GroupNormLayer(in_channels, norm_num_groups, norm_eps, "silu", **factory)
        self.conv1 = Conv3x3(in_channels, out_channels, **factory)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels, **factory)
                              if temb_dim is not None else None)
        self.norm2 = GroupNormLayer(out_channels, norm_num_groups, norm_eps, "silu", **factory)
        self.conv2 = Conv3x3(out_channels, out_channels, **factory)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, **factory)
                              if in_channels != out_channels else None)

    @staticmethod
    def _norm_conv(norm: GroupNormLayer, conv: Conv3x3, x: torch.Tensor, fused: bool,
                   shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        split = spatial.current()
        n, c, h, w = x.shape
        if fused and fused_conv_wanted((n, c, h * (1 if split is None else split.size), w)):
            return gn_silu_conv3x3(x, norm.weight, norm.bias, norm.num_groups, norm.eps,
                                   conv.weight, conv.bias, shift)
        if shift is not None:
            x = x + shift[:, :, None, None].to(x.dtype)
        return conv(norm(x))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = self.time_emb_proj(F.silu(temb)) if temb is not None else None
        h = self._norm_conv(self.norm1, self.conv1, x, self.fused_conv)
        h = self._norm_conv(self.norm2, self.conv2, h, self.fused_conv, t)
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return (residual + h) / self.output_scale_factor


class AttentionBlock2D(nn.Module):
    """Spatial self-attention over NCHW maps (diffusers VAE `Attention`):
    GroupNorm, q/k/v projections, `ops.attention.attention`, residual."""

    def __init__(self, channels: int, num_head_channels: Optional[int] = None,
                 norm_num_groups: int = 32, norm_eps: float = 1e-6,
                 rescale_output_factor: float = 1.0, **factory):
        super().__init__()
        self.num_heads = 1 if num_head_channels is None else channels // num_head_channels
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = GroupNormLayer(channels, norm_num_groups, norm_eps, None, **factory)
        self.to_q = nn.Linear(channels, channels, **factory)
        self.to_k = nn.Linear(channels, channels, **factory)
        self.to_v = nn.Linear(channels, channels, **factory)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **factory)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        heads = self.num_heads
        hid = self.group_norm(x).reshape(n, c, h * w).transpose(1, 2)
        q = self.to_q(hid).reshape(n, h * w, heads, c // heads)
        k, v = self_attention_kv(self.to_k(hid).reshape(n, h * w, heads, c // heads),
                                 self.to_v(hid).reshape(n, h * w, heads, c // heads))
        out = attention(q, k, v, scale=(c // heads) ** -0.5).reshape(n, h * w, c)
        out = self.to_out[0](out).transpose(1, 2).reshape(n, c, h, w)
        return (x + out) / self.rescale_output_factor


def self_attention_kv(k: torch.Tensor, v: torch.Tensor):
    """K and V of a self-attention over (B, S, H, D) tokens: as they are, or
    under a spatial split (the rank's rows are a contiguous token range)
    every rank's, gathered along the tokens, while Q stays the rank's."""
    split = spatial.current()
    if split is None:
        return k, v
    return spatial.gather_sum(k, split), spatial.gather_sum(v, split)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv; `padding=0` pads (0, 1, 0, 1) first (VAE encoder).

    Under a spatial split the rank's rows (an even count starting at an even
    row) take the row above (padding 1: output row i reads rows 2i - 1 ..
    2i + 1) or the row below (the (0, 1, 0, 1) pad: rows 2i .. 2i + 2),
    zeros at the image's edge, and the conv pads the width only."""

    def __init__(self, in_channels: int, out_channels: int, padding: int = 1, **factory):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=padding, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = spatial.current()
        if split is not None:
            if x.shape[2] % 2:
                raise ValueError(f"Downsample2D at {x.shape[2] * split.size} rows: "
                                 f"{x.shape[2]} rows a rank do not halve over {split.size} "
                                 "ranks (the spatial split needs every stage's rows to "
                                 "divide by its ranks)")
            if self.padding == 0:
                x = F.pad(spatial.halo_rows(x, split, above=0, below=1), (0, 1))
                return F.conv2d(x, self.conv.weight, self.conv.bias, stride=2)
            x = spatial.halo_rows(x, split, above=1, below=0)
            return F.conv2d(x, self.conv.weight, self.conv.bias, stride=2, padding=(0, 1))
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
