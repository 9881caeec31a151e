"""Model-family wrappers: the port of `pipeline/wrappers.py` for Stable
Diffusion (KL-VAE codec with the 0.18215 latent scale)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.schedule import Schedule
from ..engine.denoise import CfgEpsClosure, DecodeClosure, EncodeClosure, EpsClosure


class SD:
    """Stable Diffusion: UNet + schedule + KL-VAE codec on one device.

    `prep_text(None)` is None, as in the JAX package: the run is then
    unconditional. CLIP and the tokenizer come in a later slice, so prompt
    ids are refused; a caller with a precomputed [uncond; cond] embedding
    (2, L, D) overrides `prep_text`, as `bench.py` does. `device=None` means
    CUDA and raises without it; the modules and the schedule are moved
    there."""

    def __init__(self, unet: nn.Module, vae: nn.Module, sched: Schedule, device=None):
        self.device = resolve_device(device)
        # Inference only: the guidance gradient is taken with respect to the
        # latent, so no weight needs one (XLA drops the weights' gradients in
        # the JAX package; here autograd then skips them, the fused conv's
        # dw included).
        self.unet = unet.to(self.device).requires_grad_(False)
        self.vae = vae.to(self.device).requires_grad_(False)
        self.schedule = sched.to(self.device)
        scale = vae.config.scaling_factor
        self._encode = EncodeClosure(self.vae, scale)
        self._decode = DecodeClosure(self.vae, scale)

    def decode_fn(self) -> DecodeClosure:
        """Differentiable latent -> image callable for guidance."""
        return self._decode

    def encode(self, sample: torch.Tensor) -> torch.Tensor:
        return self._encode(sample.to(self.device))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._decode(latent)

    def prep_text(self, prompt_ids=None) -> Optional[torch.Tensor]:
        if prompt_ids is None:
            return None
        raise NotImplementedError("prompt ids need the CLIP text encoder (a later slice)")

    def eps_fn(self, text_emb: Optional[torch.Tensor] = None, cfg_scale: float = 3.5):
        if text_emb is None:
            return EpsClosure(self.unet)
        return CfgEpsClosure(self.unet, text_emb, cfg_scale)
