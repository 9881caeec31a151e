"""Denoiser and codec closures: the port of `engine/denoise.py`.

UNet calls run under `torch.no_grad()`: the guidance gradient flows through
the decoder only, never through the UNet."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

EpsFn = Callable[[torch.Tensor, object], torch.Tensor]  # (x_t, t) -> eps


class EpsClosure:
    """Unconditional denoiser: eps = unet(x, t)."""

    def __init__(self, unet: nn.Module):
        self.unet = unet

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        with torch.no_grad():
            return self.unet(x, t)


class CfgEpsClosure:
    """Classifier-free guidance as ONE batched-2 UNet call.

    `text_emb` is [uncond; cond] stacked on the batch axis, (2, L, D); a
    per-sample (B,) `t` is tiled for the pair."""

    def __init__(self, unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float = 3.5):
        self.unet = unet
        self.text_emb = text_emb
        self.cfg_scale = cfg_scale

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        b = x.shape[0]
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t, device=x.device)
        if t.dim() == 1:
            t = torch.cat([t, t])
        ctx = self.text_emb.repeat_interleave(b, dim=0)  # (2B, L, D) uncond first
        with torch.no_grad():
            eps = self.unet(torch.cat([x, x]), t, ctx)
        eps_uncond, eps_text = eps.chunk(2)
        return eps_uncond + self.cfg_scale * (eps_text - eps_uncond)


class DecodeClosure:
    """Latent -> image: decode(z / scale). `vae is None` is the identity
    codec. Differentiable: gradient flows when the caller enables it."""

    def __init__(self, vae: Optional[nn.Module] = None, scale: float = 1.0):
        self.vae = vae
        self.scale = scale

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return z
        return self.vae.decode(z / self.scale)


class EncodeClosure:
    """Image -> latent: encode(x) * scale (the distribution mode)."""

    def __init__(self, vae: Optional[nn.Module] = None, scale: float = 1.0):
        self.vae = vae
        self.scale = scale

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return x
        with torch.no_grad():
            return self.vae.encode(x) * self.scale
