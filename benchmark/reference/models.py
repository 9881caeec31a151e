"""Plain float32 reference models for the benchmark's correctness check:
a frozen copy of the diffusers-layout torch mirrors (`TorchUNet2D`,
`TorchUNet2DCondition`, `TorchAutoencoderKL`, `TorchVQModel`) with exact
diffusers key names, built from the benchmark's own configuration files.

Nothing here imports JAX or the port under test; `configs` turns a
configuration file's groups into the attribute objects these classes read.
The VQ decode carries a straight-through gradient, as the guidance's
gradient through a VQ codec needs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import AutoencoderConfig, UNet2DConditionConfig, UNet2DConfig


# --------------------------------------------------------------------------
# shared blocks
# --------------------------------------------------------------------------


class TResnet(nn.Module):
    def __init__(self, cin, cout, groups, eps, temb_dim=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class TSelfAttn2D(nn.Module):
    """Spatial self-attention (diffusers AttentionBlock / VAE Attention),
    multi-head when head_dim is set, with either key naming era."""

    def __init__(self, c, groups, eps, head_dim=None, naming="legacy"):
        super().__init__()
        self.heads = 1 if head_dim is None else c // head_dim
        self.naming = naming
        self.group_norm = nn.GroupNorm(groups, c, eps=eps)
        if naming == "legacy":
            self.query = nn.Linear(c, c)
            self.key = nn.Linear(c, c)
            self.value = nn.Linear(c, c)
            self.proj_attn = nn.Linear(c, c)
        else:
            self.to_q = nn.Linear(c, c)
            self.to_k = nn.Linear(c, c)
            self.to_v = nn.Linear(c, c)
            self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        nh = self.heads
        hd = c // nh
        hid = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        if self.naming == "legacy":
            q, k, v = self.query(hid), self.key(hid), self.value(hid)
        else:
            q, k, v = self.to_q(hid), self.to_k(hid), self.to_v(hid)
        q = q.reshape(b, -1, nh, hd).permute(0, 2, 1, 3)
        k = k.reshape(b, -1, nh, hd).permute(0, 2, 1, 3)
        v = v.reshape(b, -1, nh, hd).permute(0, 2, 1, 3)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b, -1, c)
        out = self.proj_attn(out) if self.naming == "legacy" else self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class TDownsample(nn.Module):
    def __init__(self, c, padding):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class TUpsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def timestep_embedding_torch(t, dim, flip_sin_to_cos, shift):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _container(**named):
    m = nn.Module()
    for k, v in named.items():
        setattr(m, k, v)
    return m


# --------------------------------------------------------------------------
# UNet2DModel mirror (DDPM / LDM denoisers)
# --------------------------------------------------------------------------


class TorchUNet2D(nn.Module):
    def __init__(self, cfg: UNet2DConfig, attn_naming: str = "legacy"):
        super().__init__()
        self.cfg = cfg
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        temb = cfg.time_embed_dim
        c0 = cfg.block_out_channels[0]
        self.time_embedding = _container(
            linear_1=nn.Linear(c0, temb), linear_2=nn.Linear(temb, temb)
        )
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)

        skips = [c0]
        ch = c0
        downs = []
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            is_final = i == len(cfg.down_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(TResnet(ch, out_ch, g, eps, temb))
                ch = out_ch
                if btype == "AttnDownBlock2D":
                    attns.append(TSelfAttn2D(ch, g, eps, cfg.attention_head_dim, attn_naming))
                skips.append(ch)
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if not is_final:
                blk.downsamplers = nn.ModuleList([TDownsample(ch, cfg.downsample_padding)])
                skips.append(ch)
            downs.append(blk)
        self.down_blocks = nn.ModuleList(downs)

        self.mid_block = _container(
            resnets=nn.ModuleList([TResnet(ch, ch, g, eps, temb), TResnet(ch, ch, g, eps, temb)])
        )
        if cfg.add_mid_attention:
            self.mid_block.attentions = nn.ModuleList(
                [TSelfAttn2D(ch, g, eps, cfg.attention_head_dim, attn_naming)]
            )

        ups = []
        reversed_out = list(reversed(cfg.block_out_channels))
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = reversed_out[i]
            is_final = i == len(cfg.up_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(TResnet(ch + skips.pop(), out_ch, g, eps, temb))
                ch = out_ch
                if btype == "AttnUpBlock2D":
                    attns.append(TSelfAttn2D(ch, g, eps, cfg.attention_head_dim, attn_naming))
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if not is_final:
                blk.upsamplers = nn.ModuleList([TUpsample(ch)])
            ups.append(blk)
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = nn.GroupNorm(g, ch, eps=eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, x, t):
        cfg = self.cfg
        temb = timestep_embedding_torch(
            t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        )
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        if hasattr(self.mid_block, "attentions"):
            h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# --------------------------------------------------------------------------
# UNet2DConditionModel mirror (SD 1.x)
# --------------------------------------------------------------------------


class TCrossAttention(nn.Module):
    def __init__(self, dim, heads, ctx_dim=None):
        super().__init__()
        self.heads = heads
        ctx_dim = ctx_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, s, d = x.shape
        nh = self.heads
        hd = d // nh
        q = self.to_q(x).reshape(b, s, nh, hd).permute(0, 2, 1, 3)
        k = self.to_k(ctx).reshape(b, -1, nh, hd).permute(0, 2, 1, 3)
        v = self.to_v(ctx).reshape(b, -1, nh, hd).permute(0, 2, 1, 3)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b, s, d)
        return self.to_out[0](out)


class TFeedForwardGEGLU(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([_container(proj=nn.Linear(dim, dim * 8)),
                                  nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


class TTransformer2D(nn.Module):
    def __init__(self, c, heads, ctx_dim, groups, depth=1):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        blocks = []
        for _ in range(depth):
            blocks.append(_container(
                norm1=nn.LayerNorm(c), attn1=TCrossAttention(c, heads),
                norm2=nn.LayerNorm(c), attn2=TCrossAttention(c, heads, ctx_dim),
                norm3=nn.LayerNorm(c), ff=TFeedForwardGEGLU(c),
            ))
        self.transformer_blocks = nn.ModuleList(blocks)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        res = x
        hid = self.proj_in(self.norm(x)).reshape(b, c, h * w).transpose(1, 2)
        for blk in self.transformer_blocks:
            hid = hid + blk.attn1(blk.norm1(hid))
            hid = hid + blk.attn2(blk.norm2(hid), ctx)
            hid = hid + blk.ff(blk.norm3(hid))
        hid = hid.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(hid) + res


class TorchUNet2DCondition(nn.Module):
    def __init__(self, cfg: UNet2DConditionConfig):
        super().__init__()
        self.cfg = cfg
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        heads = cfg.attention_head_dim  # number of heads (SD-1.x naming quirk)
        ctx = cfg.cross_attention_dim
        temb = cfg.time_embed_dim
        c0 = cfg.block_out_channels[0]
        self.time_embedding = _container(
            linear_1=nn.Linear(c0, temb), linear_2=nn.Linear(temb, temb)
        )
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)

        skips = [c0]
        ch = c0
        downs = []
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            is_final = i == len(cfg.down_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(TResnet(ch, out_ch, g, eps, temb))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(TTransformer2D(ch, heads, ctx, g))
                skips.append(ch)
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if not is_final:
                blk.downsamplers = nn.ModuleList([TDownsample(ch, 1)])
                skips.append(ch)
            downs.append(blk)
        self.down_blocks = nn.ModuleList(downs)

        self.mid_block = _container(
            resnets=nn.ModuleList([TResnet(ch, ch, g, eps, temb), TResnet(ch, ch, g, eps, temb)]),
            attentions=nn.ModuleList([TTransformer2D(ch, heads, ctx, g)]),
        )

        ups = []
        reversed_out = list(reversed(cfg.block_out_channels))
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = reversed_out[i]
            is_final = i == len(cfg.up_block_types) - 1
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(TResnet(ch + skips.pop(), out_ch, g, eps, temb))
                ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(TTransformer2D(ch, heads, ctx, g))
            blk = _container(resnets=nn.ModuleList(resnets))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if not is_final:
                blk.upsamplers = nn.ModuleList([TUpsample(ch)])
            ups.append(blk)
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = nn.GroupNorm(g, ch, eps=eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, x, t, ctx):
        cfg = self.cfg
        temb = timestep_embedding_torch(
            t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        )
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
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


# --------------------------------------------------------------------------
# AutoencoderKL / VQModel mirrors
# --------------------------------------------------------------------------


class TorchVAEEncoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, attn_naming):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        ch = c0
        downs = []
        for i, out_ch in enumerate(cfg.block_out_channels):
            is_final = i == len(cfg.block_out_channels) - 1
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(TResnet(ch, out_ch, g, eps))
                ch = out_ch
            blk = _container(resnets=nn.ModuleList(resnets))
            if not is_final:
                blk.downsamplers = nn.ModuleList([TDownsample(ch, 0)])
            downs.append(blk)
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = _container(
            resnets=nn.ModuleList([TResnet(ch, ch, g, eps), TResnet(ch, ch, g, eps)]),
        )
        if cfg.mid_attention:
            self.mid_block.attentions = nn.ModuleList(
                [TSelfAttn2D(ch, g, eps, naming=attn_naming)]
            )
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=eps)
        out_c = cfg.latent_channels * (2 if cfg.double_z else 1)
        self.conv_out = nn.Conv2d(ch, out_c, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        if hasattr(self.mid_block, "attentions"):
            h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TorchVAEDecoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, attn_naming):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        reversed_out = list(reversed(cfg.block_out_channels))
        ch = reversed_out[0]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _container(
            resnets=nn.ModuleList([TResnet(ch, ch, g, eps), TResnet(ch, ch, g, eps)]),
        )
        if cfg.mid_attention:
            self.mid_block.attentions = nn.ModuleList(
                [TSelfAttn2D(ch, g, eps, naming=attn_naming)]
            )
        ups = []
        for i, out_ch in enumerate(reversed_out):
            is_final = i == len(reversed_out) - 1
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(TResnet(ch, out_ch, g, eps))
                ch = out_ch
            blk = _container(resnets=nn.ModuleList(resnets))
            if not is_final:
                blk.upsamplers = nn.ModuleList([TUpsample(ch)])
            ups.append(blk)
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        if hasattr(self.mid_block, "attentions"):
            h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class TorchAutoencoderKL(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, attn_naming: str = "modern"):
        super().__init__()
        self.encoder = TorchVAEEncoder(cfg, attn_naming)
        self.decoder = TorchVAEDecoder(cfg, attn_naming)
        zc = cfg.latent_channels
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1)

    def encode_mode(self, x):
        moments = self.quant_conv(self.encoder(x))
        return moments.chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class TorchVQModel(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, attn_naming: str = "legacy"):
        super().__init__()
        self.encoder = TorchVAEEncoder(cfg, attn_naming)
        self.decoder = TorchVAEDecoder(cfg, attn_naming)
        self.quant_conv = nn.Conv2d(
            cfg.latent_channels * (2 if cfg.double_z else 1), cfg.vq_embed_dim, 1
        )
        self.post_quant_conv = nn.Conv2d(cfg.vq_embed_dim, cfg.latent_channels, 1)
        self.quantize = _container(
            embedding=nn.Embedding(cfg.num_vq_embeddings, cfg.vq_embed_dim)
        )

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, h):
        codes = self.quantize.embedding.weight  # (N, D)
        flat = h.permute(0, 2, 3, 1).reshape(-1, codes.shape[1])
        d = (flat**2).sum(1, keepdim=True) - 2 * flat @ codes.T + (codes**2).sum(1)[None]
        q = codes[d.argmin(1)].reshape(h.shape[0], h.shape[2], h.shape[3], -1)
        q = q.permute(0, 3, 1, 2)
        q = h + (q - h).detach()  # straight-through: the gradient is the identity to h
        return self.decoder(self.post_quant_conv(q))
