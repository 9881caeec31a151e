"""Denoiser and codec closures and the generation loop: the port of
`engine/denoise.py`.

UNet calls run under `torch.no_grad()`: the guidance gradient flows through
the decoder only, never through the UNet. Each denoiser call runs in the
tracer's span `models.unet`."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core import schedule as S
from ..utils.logging import span

EpsFn = Callable[[torch.Tensor, object], torch.Tensor]  # (x_t, t) -> eps


class EpsClosure:
    """Unconditional denoiser: eps = unet(x, t)."""

    def __init__(self, unet: nn.Module):
        self.unet = unet

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        with span("models.unet"), torch.no_grad():
            return self.unet(x, t)


class EpsFeatClosure(EpsClosure):
    """`EpsClosure` with encoder propagation (see `CfgEpsFeatClosure`)."""

    def full(self, x: torch.Tensor, t):
        with span("models.unet"), torch.no_grad():
            return self.unet(x, t, return_encoder_features=True)

    def reuse(self, x: torch.Tensor, t, feats) -> torch.Tensor:
        with span("models.unet"), torch.no_grad():
            return self.unet(x, t, encoder_features=feats)


class CfgEpsClosure:
    """Classifier-free guidance as ONE batched-2 UNet call.

    `text_emb` is [uncond; cond] stacked on the batch axis, (2, L, D); a
    per-sample (B,) `t` is tiled for the pair."""

    def __init__(self, unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float = 3.5):
        self.unet = unet
        self.text_emb = text_emb
        self.cfg_scale = cfg_scale

    def _pair(self, x: torch.Tensor, t):
        b = x.shape[0]
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t, device=x.device)
        if t.dim() == 1:
            t = torch.cat([t, t])
        ctx = self.text_emb.repeat_interleave(b, dim=0)  # (2B, L, D) uncond first
        return torch.cat([x, x]), t, ctx

    def _mix(self, eps: torch.Tensor) -> torch.Tensor:
        eps_uncond, eps_text = eps.chunk(2)
        return eps_uncond + self.cfg_scale * (eps_text - eps_uncond)

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        with span("models.unet"), torch.no_grad():
            return self._mix(self.unet(*self._pair(x, t)))


class CfgEpsFeatClosure(CfgEpsClosure):
    """`CfgEpsClosure` with encoder propagation (Faster Diffusion, arXiv
    2312.09608): `full` also returns the UNet's down-path activations of
    the batch-2B pair; `reuse` takes them and recomputes only mid + up with
    the current timestep embedding. Approximate by design, opt-in through
    `encoder_reuse`; `reuse` given the same (x, t)'s features equals
    `full`'s eps exactly."""

    def full(self, x: torch.Tensor, t):
        with span("models.unet"), torch.no_grad():
            eps, feats = self.unet(*self._pair(x, t), return_encoder_features=True)
            return self._mix(eps), feats

    def reuse(self, x: torch.Tensor, t, feats) -> torch.Tensor:
        with span("models.unet"), torch.no_grad():
            return self._mix(self.unet(*self._pair(x, t), encoder_features=feats))


class DecodeClosure:
    """Latent -> image: decode(z / scale). `vae is None` is the identity
    codec. Differentiable: gradient flows when the caller enables it;
    `remat=True` checkpoints the decoder's blocks along it."""

    def __init__(self, vae: Optional[nn.Module] = None, scale: float = 1.0,
                 remat: bool = False):
        self.vae = vae
        self.scale = scale
        self.remat = remat

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return z
        return self.vae.decode(z / self.scale, remat=self.remat)


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


class Trajectory(NamedTuple):
    """Final latent plus optional per-step traces (stacked on axis 0)."""

    x0: torch.Tensor
    xts: Optional[torch.Tensor] = None
    model_outputs: Optional[torch.Tensor] = None
    pred_original_samples: Optional[torch.Tensor] = None


def generate(
    sched: S.Schedule,
    eps_fn: EpsFn,
    xt: torch.Tensor,
    eta: float = 0.0,
    zs: Optional[torch.Tensor] = None,
    num_steps: Optional[int] = None,
    step_rule: str = "ddim",
    collect: bool = False,
    encoder_reuse: int = 1,
) -> Trajectory:
    """The denoising loop x_T -> x_0: `engine.edit.edit_split` with no
    attribute function. Only the last n timesteps run, n = `num_steps`,
    else len(zs), else the schedule's (the reference's truncation); zs[-n:]
    (S', B, C, H, W) is the per-step variance noise, required when eta > 0.
    `step_rule` "ddim" takes `ddim_step`, "ddpm" the edit-friendly
    `reverse_step`. `encoder_reuse=k > 1`: encoder propagation (see
    `engine.edit.edit_split`), which needs a feature-capable eps_fn."""
    from .edit import edit_split  # engine.edit imports this module

    return Trajectory(*edit_split(sched, eps_fn, xt, eta=eta, zs=zs, step_rule=step_rule,
                                  collect=collect, num_steps=num_steps,
                                  encoder_reuse=encoder_reuse))
