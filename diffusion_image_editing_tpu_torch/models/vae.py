"""SD's KL autoencoder and LDM's VQ autoencoder in torch, NCHW: the port of
`models/vae.py` (`AutoencoderKL`, `VectorQuantizer`, `VQModel`), with
diffusers' key names and the modern `to_q/to_k/to_v/to_out.0` attention
naming.

KL: `encode` returns the distribution mode (the latent mean). VQ: `encode`
returns the pre-quantization latent and `decode` quantizes first, with a
straight-through gradient. Both decodes are differentiable end to end, the
path of the guidance gradient; `decode(..., remat=True)` checkpoints the
decoder's blocks along it."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..ops.conv import Conv3x3
from ..ops.split import recompute_context
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
    # VQ only: the codebook's size and width
    num_vq_embeddings: int = 8192
    vq_embed_dim: int = 3
    mid_attention: bool = True
    # Fold each ResnetBlock's GroupNorm+SiLU into its conv where the shape
    # allows (`ops.fused_conv`): the JAX package's DIE_TPU_FUSED_CONV=1.
    fused_conv: bool = False


SD_VAE = AutoencoderConfig()  # CompVis/stable-diffusion-v1-4 `vae`

# stabilityai/stable-diffusion-xl-base-1.0 `vae`: SD's architecture at 1024 px
SDXL_VAE = AutoencoderConfig(sample_size=1024, scaling_factor=0.13025)

LDM_CELEBAHQ_VQVAE = AutoencoderConfig(  # CompVis/ldm-celebahq-256 `vqvae`
    latent_channels=3,
    block_out_channels=(128, 256, 512),
    layers_per_block=2,
    sample_size=256,
    scaling_factor=1.0,
    double_z=False,
    num_vq_embeddings=8192,
    vq_embed_dim=3,
)

TINY_VAE = AutoencoderConfig(
    latent_channels=4,
    block_out_channels=(16, 32),
    layers_per_block=1,
    norm_num_groups=8,
    sample_size=32,
)

# A VQ autoencoder at TINY_VAE's widths: 32 px images, 16 x 16 x 3 latents
# (TINY_UNET2D's sample), a codebook of 64 codes.
TINY_VQVAE = AutoencoderConfig(
    latent_channels=3,
    block_out_channels=(16, 32),
    layers_per_block=1,
    norm_num_groups=8,
    sample_size=32,
    scaling_factor=1.0,
    double_z=False,
    num_vq_embeddings=64,
    vq_embed_dim=3,
)


def _resnet_kw(cfg: AutoencoderConfig, fk: dict) -> dict:
    return dict(fk, fused_conv=cfg.fused_conv)


def _mid_block(cfg: AutoencoderConfig, ch: int, **fk) -> _Block:
    g, eps = cfg.norm_num_groups, cfg.norm_eps
    attns = [AttentionBlock2D(ch, None, g, eps, **fk)] if cfg.mid_attention else None
    return _Block([ResnetBlock2D(ch, ch, None, g, eps, **_resnet_kw(cfg, fk)),
                   ResnetBlock2D(ch, ch, None, g, eps, **_resnet_kw(cfg, fk))], attns)


def _call(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return block(h)


def _checkpointed(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """`block(h)` keeping only `h` for the backward, which runs the block's
    forward again, under the spatial split of the forward (its halo,
    GroupNorm and K/V collectives then run again, in the same order on
    every rank). Non-reentrant: `torch.autograd.grad` with respect to the
    decoder's input (the guidance gradient) goes through it."""
    return checkpoint(block, h, use_reentrant=False, context_fn=recompute_context)


def _run_mid(block: _Block, h: torch.Tensor, run=_call) -> torch.Tensor:
    h = run(block.resnets[0], h)
    if hasattr(block, "attentions"):
        h = run(block.attentions[0], h)
    return run(block.resnets[1], h)


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

    def forward(self, z: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """`remat=True` checkpoints every ResnetBlock2D and the mid
        attention: a gradient through the decoder then keeps only each
        block's input and recomputes the block's forward in the backward
        (the JAX package's `nn.remat` of the same blocks). The same weights
        serve both modes."""
        run = _checkpointed if remat else _call
        h = _run_mid(self.mid_block, self.conv_in(z), run)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = run(resnet, h)
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

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, log-variance), the log-variance clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_moments(x)[0]

    def encode_sample(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """A draw from the posterior: mean + exp(logvar / 2) * `noise`, the
        standard normal noise given as a tensor of the latent's shape."""
        mean, logvar = self.encode_moments(x)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)

    def decode(self, z: torch.Tensor, remat: bool = False) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)), remat=remat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook quantizer with a straight-through gradient.

    Distances and the argmin are f32 whatever the codebook's dtype (the JAX
    package's f32 codebook promotes a bf16 latent). Returns the quantized
    latent in f32, NCHW; its gradient is the identity to `z`."""

    def __init__(self, num_embeddings: int, embed_dim: int, **factory):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embed_dim, **factory)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """(N, H, W) codebook indices of the NCHW latent."""
        codes = self.embedding.weight.detach().float()
        n, d, h, w = z.shape
        flat = z.detach().float().permute(0, 2, 3, 1).reshape(-1, d)
        dist = ((flat * flat).sum(1, keepdim=True) - 2.0 * flat @ codes.T
                + (codes * codes).sum(1)[None, :])
        return dist.argmin(dim=1).reshape(n, h, w)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        quantized = self.embedding.weight.float()[self.indices(z)].permute(0, 3, 1, 2)
        zf = z.float()
        return zf + (quantized - zf).detach()


class VQModel(nn.Module):
    """VQ autoencoder (diffusers `VQModel`), NCHW: `encode` returns the
    pre-quantization latent, `decode` quantizes it (unless
    `force_not_quantize`) and decodes. Built on `device` (None = CUDA,
    raising without it) with parameters in `dtype`."""

    def __init__(self, config: AutoencoderConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        fk = dict(device=resolve_device(device), dtype=dtype)
        zc = config.latent_channels
        self.encoder = Encoder(config, **fk)
        self.decoder = Decoder(config, **fk)
        self.quant_conv = nn.Conv2d(zc * (2 if config.double_z else 1), config.vq_embed_dim, 1,
                                    **fk)
        self.post_quant_conv = nn.Conv2d(config.vq_embed_dim, zc, 1, **fk)
        self.quantize = VectorQuantizer(config.num_vq_embeddings, config.vq_embed_dim, **fk)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x.to(self.dtype)))

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False,
               remat: bool = False) -> torch.Tensor:
        q = h if force_not_quantize else self.quantize(h)
        return self.decoder(self.post_quant_conv(q.to(self.dtype)), remat=remat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
