"""The plain float32 reference of the SDXL base 1.0 UNet
(`stabilityai/stable-diffusion-xl-base-1.0`, `unet/config.json`), with
diffusers' `UNet2DConditionModel` key names, built from the pieces of
`models.py` (`TResnet`, `TCrossAttention`, `TDownsample`, `TUpsample`,
`timestep_embedding_torch`).

What it adds to the SD-1.x UNet there: transformer depth and head count per
level (the mid block takes the last level's, the up blocks the lists
reversed), linear `proj_in` / `proj_out` over the tokens, levels without
attention, and the `text_time` added conditioning: the sinusoidal
embedding of the six `time_ids` (original size, crop's top-left, target
size) beside the pooled text embedding, through `add_embedding`, added to
the timestep's embedding.

Departures from the published model, all three the program's too:
- LayerNorm eps 1e-6 (diffusers: 1e-5) and the tanh form of GELU in GEGLU
  (diffusers: erf), the two choices the port takes from the JAX package;
- the published EulerDiscrete schedule's betas are stepped as DDIM
  (`diffusion.py`).

Float32, no kernels, no cache, no batching tricks. Imports neither JAX nor
the port: the configuration record `SDXLUNetConfig` holds the published
keys, which `configs.UNet2DConditionConfig` refuses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import _from_dict
from .models import (TCrossAttention, TDownsample, TResnet, TUpsample, _container,
                     timestep_embedding_torch)

LAYER_NORM_EPS = 1e-6

PerLevel = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig:
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = ()
    up_block_types: Tuple[str, ...] = ()
    layers_per_block: int = 2
    attention_head_dim: PerLevel = (5, 10, 20)  # the heads of each level (diffusers' naming)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    transformer_layers_per_block: PerLevel = (1, 2, 10)
    use_linear_projection: bool = True
    addition_embed_type: Optional[str] = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def per_level(self, value: PerLevel) -> Tuple[int, ...]:
        n = len(self.block_out_channels)
        return (value,) * n if isinstance(value, int) else tuple(value)

    @property
    def pooled_dim(self) -> int:
        """The pooled text embedding's width: what `add_embedding` takes
        beside the six time_ids' embeddings (1280)."""
        return self.projection_class_embeddings_input_dim - 6 * self.addition_time_embed_dim

    @classmethod
    def from_dict(cls, d: dict) -> "SDXLUNetConfig":
        return _from_dict(cls, d)


class TFeedForwardGEGLUTanh(nn.Module):
    """GEGLU with the tanh form of GELU; keys `net.0.proj` and `net.2`."""

    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([_container(proj=nn.Linear(dim, dim * 8)),
                                  nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))


class TLinearTransformer2D(nn.Module):
    """Transformer2D with linear projections: GroupNorm, tokens, proj_in,
    `depth` blocks (self-attention, cross-attention, GEGLU, each after a
    LayerNorm and added back), proj_out, back to NCHW, plus the input."""

    def __init__(self, c, heads, ctx_dim, groups, depth):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([_container(
            norm1=nn.LayerNorm(c, eps=LAYER_NORM_EPS), attn1=TCrossAttention(c, heads),
            norm2=nn.LayerNorm(c, eps=LAYER_NORM_EPS), attn2=TCrossAttention(c, heads, ctx_dim),
            norm3=nn.LayerNorm(c, eps=LAYER_NORM_EPS), ff=TFeedForwardGEGLUTanh(c),
        ) for _ in range(depth)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        hid = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hid = self.proj_in(hid)
        for blk in self.transformer_blocks:
            hid = hid + blk.attn1(blk.norm1(hid))
            hid = hid + blk.attn2(blk.norm2(hid), ctx)
            hid = hid + blk.ff(blk.norm3(hid))
        hid = self.proj_out(hid)
        return hid.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class TorchSDXLUNet(nn.Module):
    """The SDXL UNet: forward(x, t, ctx, text_embeds, time_ids) -> eps."""

    def __init__(self, cfg: SDXLUNetConfig):
        super().__init__()
        if cfg.addition_embed_type != "text_time" or not cfg.use_linear_projection:
            raise ValueError("the SDXL reference takes text_time conditioning and linear "
                             "projections")
        self.cfg = cfg
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        heads = cfg.per_level(cfg.attention_head_dim)
        depths = cfg.per_level(cfg.transformer_layers_per_block)
        ctx, temb = cfg.cross_attention_dim, cfg.time_embed_dim
        c0, levels = cfg.block_out_channels[0], len(cfg.block_out_channels)
        self.time_embedding = _container(linear_1=nn.Linear(c0, temb),
                                         linear_2=nn.Linear(temb, temb))
        self.add_embedding = _container(
            linear_1=nn.Linear(cfg.projection_class_embeddings_input_dim, temb),
            linear_2=nn.Linear(temb, temb))
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)

        skips, ch, downs = [c0], c0, []
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(TResnet(ch, out_ch, g, eps, temb))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(TLinearTransformer2D(ch, heads[i], ctx, g, depths[i]))
                skips.append(ch)
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if i < levels - 1:
                blk.downsamplers = nn.ModuleList([TDownsample(ch, 1)])
                skips.append(ch)
            downs.append(blk)
        self.down_blocks = nn.ModuleList(downs)

        self.mid_block = _container(
            resnets=nn.ModuleList([TResnet(ch, ch, g, eps, temb), TResnet(ch, ch, g, eps, temb)]),
            attentions=nn.ModuleList([TLinearTransformer2D(ch, heads[-1], ctx, g, depths[-1])]))

        ups = []
        for i, btype in enumerate(cfg.up_block_types):
            level = levels - 1 - i
            out_ch = cfg.block_out_channels[level]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(TResnet(ch + skips.pop(), out_ch, g, eps, temb))
                ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(TLinearTransformer2D(ch, heads[level], ctx, g, depths[level]))
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if i < len(cfg.up_block_types) - 1:
                blk.upsamplers = nn.ModuleList([TUpsample(ch)])
            ups.append(blk)
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = nn.GroupNorm(g, ch, eps=eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    @staticmethod
    def _mlp(m, x):
        return m.linear_2(F.silu(m.linear_1(x)))

    def embedding(self, t, text_embeds, time_ids):
        """The timestep's embedding plus the `text_time` embedding, (B, 4 c0)."""
        cfg = self.cfg
        temb = self._mlp(self.time_embedding, timestep_embedding_torch(
            t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift))
        time_embeds = timestep_embedding_torch(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                               cfg.flip_sin_to_cos, cfg.freq_shift)
        add = torch.cat([text_embeds, time_embeds.reshape(t.shape[0], -1)], dim=-1)
        return temb + self._mlp(self.add_embedding, add)

    def forward(self, x, t, ctx, text_embeds, time_ids):
        temb = self.embedding(t, text_embeds, time_ids)
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def cfg_eps(unet: TorchSDXLUNet, ctx: torch.Tensor, text_embeds: torch.Tensor,
            time_ids: torch.Tensor, scale: float):
    """Classifier-free guidance with SDXL's conditioning, each tensor
    [uncond; cond] on the batch axis and repeated per sample."""
    def eps(x, t):
        b = x.shape[0]
        t = torch.as_tensor(t, device=x.device).long()
        t = t.expand(b) if t.dim() == 0 else t
        out = unet(torch.cat([x, x]), torch.cat([t, t]), ctx.repeat_interleave(b, dim=0),
                   text_embeds.repeat_interleave(b, dim=0), time_ids.repeat_interleave(b, dim=0))
        u, c = out.chunk(2)
        return u + scale * (c - u)
    return eps
