"""Text-conditional UNet (Stable Diffusion 1.x and SDXL) in torch, NCHW: the
port of `models/unet2d_cond.py` with diffusers' `UNet2DConditionModel` key
names.

`UNet2DConditionConfig` holds SD-1.x's keys; `SDXLUNetConfig` adds SDXL's:
transformer depth and head count per level, linear `proj_in` / `proj_out`,
and the `text_time` added conditioning (a pooled text embedding and six
micro-conditioning numbers, embedded and added to the timestep's). One
module builds both.

Two choices follow the JAX package, not diffusers, so the port reproduces it:
LayerNorm eps 1e-6 (Flax's default) and the tanh form of GELU in GEGLU
(Flax's `nn.gelu` default). SDXL's configuration takes them too.

Tracing: each `Transformer2D` stack runs in the span
`models.unet.transformer` (its depth as `index`), and the counter
`models.unet.transformer_blocks` counts the transformer blocks run."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.attention import attention
from ..ops.conv import Conv3x3
from ..utils.logging import COUNTERS, span
from .layers import (
    Downsample2D,
    GroupNormLayer,
    ResnetBlock2D,
    TimeEmbedding,
    Upsample2D,
    self_attention_kv,
    timestep_embedding,
)

LAYER_NORM_EPS = 1e-6


PerLevel = Union[int, Tuple[int, ...]]  # one value for every level, or one a level


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: PerLevel = 8  # number of heads (diffusers naming quirk)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # Fold each ResnetBlock's GroupNorm(+temb)+SiLU into its conv where the
    # shape allows (`ops.fused_conv`): the JAX package's DIE_TPU_FUSED_CONV=1.
    fused_conv: bool = False

    # SDXL's keys, fields of `SDXLUNetConfig`: here class attributes holding
    # SD-1.x's values, so that this config's fields (and the dicts made from
    # them) stay SD-1.x's.
    transformer_layers_per_block = 1
    use_linear_projection = False
    addition_embed_type = None
    addition_time_embed_dim = None
    projection_class_embeddings_input_dim = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def per_level(self, value: PerLevel) -> Tuple[int, ...]:
        """A per-level key as one value a level, down the UNet."""
        n = len(self.block_out_channels)
        out = (value,) * n if isinstance(value, int) else tuple(value)
        if len(out) != n:
            raise ValueError(f"{value!r} does not give one value for each of {n} levels")
        return out

    @property
    def heads(self) -> Tuple[int, ...]:
        return self.per_level(self.attention_head_dim)

    @property
    def depths(self) -> Tuple[int, ...]:
        return self.per_level(self.transformer_layers_per_block)

    def _stacks(self) -> list:
        """The depth of each Transformer2D stack of one forward: down, mid, up."""
        d = self.depths
        down = [d[i] for i, t in enumerate(self.down_block_types) if t == "CrossAttnDownBlock2D"]
        up = [d[::-1][i] for i, t in enumerate(self.up_block_types) if t == "CrossAttnUpBlock2D"]
        return down * self.layers_per_block + [d[-1]] + up * (self.layers_per_block + 1)

    @property
    def num_transformers(self) -> int:
        """Transformer2D stacks in one forward."""
        return len(self._stacks())

    @property
    def num_transformer_blocks(self) -> int:
        """Transformer blocks in one forward (each runs two attentions)."""
        return sum(self._stacks())


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig(UNet2DConditionConfig):
    """`UNet2DConditionConfig` with SDXL's keys as fields: per-level
    transformer depth (the mid block takes the last level's, the up blocks
    the list reversed) and head count, linear projections in and out of
    each Transformer2D, and `addition_embed_type="text_time"`: the
    sinusoidal embedding (`addition_time_embed_dim` a number) of the six
    `time_ids` beside the pooled text embedding,
    `projection_class_embeddings_input_dim` wide in all, through
    `add_embedding` into the timestep embedding."""

    transformer_layers_per_block: PerLevel = 1
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None


SD15_UNET = UNet2DConditionConfig()  # CompVis SD-1.4 / runwayml SD-1.5

TINY_SD_UNET = UNet2DConditionConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    attention_head_dim=2,
    cross_attention_dim=32,
    norm_num_groups=8,
)

# stabilityai/stable-diffusion-xl-base-1.0 `unet/config.json`: 2.57 B parameters
SDXL_UNET = SDXLUNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=2,
    attention_head_dim=(5, 10, 20),
    cross_attention_dim=2048,
    transformer_layers_per_block=(1, 2, 10),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)

# SDXL's mechanisms at TINY widths: two levels, depths (1, 2), per-level heads
TINY_SDXL_UNET = SDXLUNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    attention_head_dim=(2, 4),
    cross_attention_dim=48,
    norm_num_groups=8,
    transformer_layers_per_block=(1, 2),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 6 * 8,
)


class CrossAttention(nn.Module):
    """Multi-head attention, cross when `context` is given. q/k/v
    projections without bias, output projection with (diffusers Attention)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None, **factory):
        super().__init__()
        self.heads = heads
        ctx = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False, **factory)
        self.to_k = nn.Linear(ctx, dim, bias=False, **factory)
        self.to_v = nn.Linear(ctx, dim, bias=False, **factory)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, **factory)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, s, dim = x.shape
        hd = dim // self.heads
        q = self.to_q(x).reshape(b, s, self.heads, hd)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], self.heads, hd)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], self.heads, hd)
        if context is None:  # the context's K/V are whole on every rank already
            k, v = self_attention_kv(k, v)
        out = attention(q, k, v, scale=hd ** -0.5).reshape(b, s, dim)
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int, **factory):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2, **factory)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward; keys `net.0.proj` and `net.2` as in diffusers."""

    def __init__(self, dim: int, mult: int = 4, **factory):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLUProj(dim, inner, **factory), nn.Identity(),
                                  nn.Linear(inner, dim, **factory)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, **factory):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS, **factory)
        self.attn1 = CrossAttention(dim, heads, **factory)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS, **factory)
        self.attn2 = CrossAttention(dim, heads, context_dim, **factory)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS, **factory)
        self.ff = FeedForwardGEGLU(dim, **factory)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> proj_in -> transformer block(s) -> proj_out + residual;
    the projections are 1x1 convs (SD-1.x) or, with `linear`, linear maps
    over the tokens (SDXL's `use_linear_projection`)."""

    def __init__(self, channels: int, heads: int, context_dim: int, norm_num_groups: int = 32,
                 depth: int = 1, linear: bool = False, **factory):
        super().__init__()
        self.linear = linear
        proj = (lambda: nn.Linear(channels, channels, **factory)) if linear else \
            (lambda: nn.Conv2d(channels, channels, 1, **factory))
        self.norm = GroupNormLayer(channels, norm_num_groups, 1e-6, None, **factory)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim, **factory) for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        depth = len(self.transformer_blocks)
        with span("models.unet.transformer", depth):
            COUNTERS["models.unet.transformer_blocks"] += depth
            if self.linear:
                hid = self.proj_in(self.norm(x).reshape(n, c, h * w).transpose(1, 2))
            else:
                hid = self.proj_in(self.norm(x)).reshape(n, c, h * w).transpose(1, 2).contiguous()
            for block in self.transformer_blocks:
                hid = block(hid, context)
            if self.linear:
                return self.proj_out(hid).transpose(1, 2).reshape(n, c, h, w) + x
            hid = hid.transpose(1, 2).reshape(n, c, h, w)
            return self.proj_out(hid) + x


class _Block(nn.Module):
    """A down/mid/up stage: `resnets`, optional `attentions`, and optional
    `downsamplers`/`upsamplers` (diffusers' container names)."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


class UNet2DCondition(nn.Module):
    """SD / SDXL UNet, NCHW. Built on `device` (None = CUDA, raising without
    it) with parameters in `dtype`; `forward` returns f32 eps."""

    def __init__(self, config: UNet2DConditionConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = cfg = config
        fk = dict(device=resolve_device(device), dtype=dtype)
        rk = dict(fk, fused_conv=cfg.fused_conv)  # ResnetBlock2D keywords
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        ctx, temb = cfg.cross_attention_dim, cfg.time_embed_dim
        heads, depths = cfg.heads, cfg.depths
        c0 = cfg.block_out_channels[0]
        self.time_embedding = TimeEmbedding(c0, temb, **fk)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimeEmbedding(cfg.projection_class_embeddings_input_dim, temb,
                                               **fk)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r} is not supported")
        self.conv_in = Conv3x3(cfg.in_channels, c0, **fk)

        def transformer(ch: int, level: int) -> Transformer2D:
            return Transformer2D(ch, heads[level], ctx, g, depths[level],
                                 cfg.use_linear_projection, **fk)

        skips, ch, downs = [c0], c0, []
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb, g, eps, **rk))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(transformer(ch, i))
                skips.append(ch)
            down = None
            if i < len(cfg.down_block_types) - 1:
                down = [Downsample2D(ch, ch, padding=1, **fk)]
                skips.append(ch)
            downs.append(_Block(resnets, attns, downsamplers=down))
        self.down_blocks = nn.ModuleList(downs)

        self.mid_block = _Block(
            [ResnetBlock2D(ch, ch, temb, g, eps, **rk), ResnetBlock2D(ch, ch, temb, g, eps, **rk)],
            [transformer(ch, -1)])

        ups, levels = [], len(cfg.block_out_channels)
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = list(reversed(cfg.block_out_channels))[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skips.pop(), out_ch, temb, g, eps, **rk))
                ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(transformer(ch, levels - 1 - i))
            up = [Upsample2D(ch, ch, **fk)] if i < len(cfg.up_block_types) - 1 else None
            ups.append(_Block(resnets, attns, upsamplers=up))
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = GroupNormLayer(ch, g, eps, "silu", **fk)
        self.conv_out = Conv3x3(ch, cfg.out_channels, **fk)

    def _added_embedding(self, added_cond: dict, batch: int) -> torch.Tensor:
        """SDXL's `text_time` embedding: the sinusoidal embedding of each of
        the six time_ids beside the pooled text embedding, through
        `add_embedding`."""
        cfg = self.config
        text_embeds, time_ids = added_cond["text_embeds"], added_cond["time_ids"]
        time_embeds = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                         cfg.flip_sin_to_cos, cfg.freq_shift)
        add = torch.cat([text_embeds.float(), time_embeds.reshape(batch, -1)], dim=-1)
        return self.add_embedding(add)

    def forward(self, sample: torch.Tensor, timesteps, context: torch.Tensor,
                encoder_features=None, return_encoder_features: bool = False,
                added_cond: Optional[dict] = None):
        """sample (B, C, H, W); timesteps a scalar or (B,); context (B, L, D);
        `added_cond` SDXL's {"text_embeds": (B, P), "time_ids": (B, 6)},
        required by a `text_time` config and refused by the others.

        Encoder propagation (Faster Diffusion, arXiv 2312.09608), opt-in:
        `return_encoder_features=True` also returns the down path's output
        {"h": ..., "skips": (...)} (NCHW); a call given `encoder_features`
        skips conv_in and every down block and recomputes mid + up with the
        current timestep embedding. Features of the same (sample, t) give
        the full forward's eps exactly."""
        cfg = self.config
        if (added_cond is None) != (cfg.addition_embed_type is None):
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r} takes "
                             f"{'no' if cfg.addition_embed_type is None else 'its'} added_cond")
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(np.asarray(timesteps) if not torch.is_tensor(timesteps)
                            else timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(sample.shape[0])
        t_emb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                   cfg.freq_shift)
        temb = self.time_embedding(t_emb)
        if added_cond is not None:
            temb = temb + self._added_embedding(added_cond, sample.shape[0])
        context = context.to(dtype)

        if encoder_features is not None:
            h, skips = encoder_features["h"], list(encoder_features["skips"])
        else:
            h = self.conv_in(sample.to(dtype))
            skips = [h]
            for block in self.down_blocks:
                for j, resnet in enumerate(block.resnets):
                    h = resnet(h, temb)
                    if hasattr(block, "attentions"):
                        h = block.attentions[j](h, context)
                    skips.append(h)
                if hasattr(block, "downsamplers"):
                    h = block.downsamplers[0](h)
                    skips.append(h)
        feats = {"h": h, "skips": tuple(skips)} if return_encoder_features else None

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        out = self.conv_out(self.conv_norm_out(h)).float()
        return (out, feats) if return_encoder_features else out
