"""Stable Diffusion 1.x: UNet2DCondition and the KL VAE, with
classifier-free guidance over a fixed [uncond; cond] text embedding made
from the seed in place of the CLIP text encoder (weights tagged "unet",
"vae" and "text_embedding")."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..harness.models import Program, Reference, config_dict, serve_dtype, tuples
from ..harness.weights import fill_seeded, mix_seed, program_module
from ..reference import configs as RC
from ..reference import diffusion as R
from ..reference import models as RM

ROWS = 2  # the CFG pair


def image_size(cfg: dict) -> int:
    return cfg["vae"]["sample_size"]


def text_embedding(cfg: dict, seed: int, device) -> torch.Tensor:
    """The fixed [uncond; cond] embedding, (2, L, D), in the served dtype."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, "text_embedding"))
    return torch.randn(tuple(cfg["text_embedding"]), generator=gen, device=device,
                       dtype=serve_dtype(cfg))


def build_program(cfg: dict, seed: int, device, steps: int) -> Program:
    from diffusion_image_editing_tpu_torch import models as M
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import SD

    dt = serve_dtype(cfg)
    sched = schedule_for_model("sd", steps, clip_sample=False)
    ucfg = M.UNet2DConditionConfig(**tuples(cfg["unet"]))
    vcfg = M.AutoencoderConfig(**tuples(cfg["vae"]))
    unet = program_module(lambda d: M.UNet2DCondition(ucfg, device=d, dtype=dt), device)
    vae = program_module(lambda d: M.AutoencoderKL(vcfg, device=d, dtype=dt), device)
    fill_seeded(unet, seed, "unet", dt, device)
    fill_seeded(vae, seed, "vae", dt, device)
    fixed = text_embedding(cfg, seed, device)

    class FixedTextSD(SD):
        """SD whose every prompt is the fixed embedding."""

        def prep_text(self, prompt_ids=None):
            return fixed

    return Program(FixedTextSD(unet, vae, sched, device=device))


@dataclasses.dataclass
class SDReference(Reference):
    text: Optional[torch.Tensor] = None  # [uncond; cond], float32
    cfg_scale: float = 3.5
    codec_tag = "vae"

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        return self.codec.encode_mode(img) * self.scale

    def eps_fn(self):
        return R.cfg_eps(self.unet, self.text, self.cfg_scale)

    def unet_once(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t, self.text[:1])

    def fill(self, cfg: dict, seed: int, device) -> None:
        super().fill(cfg, seed, device)
        self.text = text_embedding(cfg, seed, device).float()


def reference_modules(cfg: dict, device) -> SDReference:
    with torch.device(device):
        unet = RM.TorchUNet2DCondition(RC.UNet2DConditionConfig.from_dict(cfg["unet"]))
        vcfg = RC.AutoencoderConfig.from_dict(cfg["vae"])
        codec = RM.TorchAutoencoderKL(vcfg, attn_naming="modern")
        text = torch.empty(tuple(cfg["text_embedding"]))
    return SDReference(unet, codec, vcfg.scaling_factor, text=text,
                       cfg_scale=cfg.get("cfg_scale", 3.5))


def tiny() -> dict:
    from diffusion_image_editing_tpu_torch import models as M

    return dict(unet=config_dict(M.TINY_SD_UNET),
                vae=config_dict(dataclasses.replace(M.TINY_VAE, sample_size=16)),
                text_embedding=[2, 7, 32])
