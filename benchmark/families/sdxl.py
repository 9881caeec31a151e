"""Stable Diffusion XL base 1.0: the SDXL UNet (per-level transformer depth
and heads, linear projections, `text_time` added conditioning) and the KL
VAE at 1024 px, with classifier-free guidance over a fixed conditioning
made from the seed in place of the two text encoders: the [uncond; cond]
context (weights tagged "text_embedding"), the pooled embedding
("pooled_embedding") and the configuration's `time_ids` (weights tagged
"unet" and "vae").

While a profiler records, each Transformer2D stack of the program's UNet
runs inside the range `bench.xfmr` (the program's span
`models.unet.transformer`), which `metrics/xfmr_ms.py` reads."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

from ..harness.models import Program, Reference, config_dict, serve_dtype, tuples
from ..harness.weights import fill_seeded, mix_seed, program_module
from ..reference import configs as RC
from ..reference import models as RM
from ..reference import sdxl as RX

ROWS = 2  # the CFG pair
XFMR = "bench.xfmr"


def image_size(cfg: dict) -> int:
    return cfg["vae"]["sample_size"]


def conditioning(cfg: dict, seed: int, device) -> tuple:
    """The fixed [uncond; cond] context (2, L, D) and pooled embedding
    (2, P), drawn from the seed in the served dtype, and the time_ids
    (2, 6), float32."""
    def draw(key):
        gen = torch.Generator(device=device).manual_seed(mix_seed(seed, key))
        return torch.randn(tuple(cfg[key]), generator=gen, device=device, dtype=serve_dtype(cfg))

    time_ids = torch.tensor([cfg["time_ids"]] * 2, dtype=torch.float32, device=device)
    return draw("text_embedding"), draw("pooled_embedding"), time_ids


def _ranged(forward):
    def run(*args, **kwargs):
        if not _profiler_enabled():
            return forward(*args, **kwargs)
        with record_function(XFMR):
            return forward(*args, **kwargs)
    return run


def build_program(cfg: dict, seed: int, device, steps: int) -> Program:
    from diffusion_image_editing_tpu_torch import models as M
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import SDXL, SDXLText

    dt = serve_dtype(cfg)
    sched = schedule_for_model("sdxl", steps, clip_sample=False)
    ucfg = M.SDXLUNetConfig(**tuples(cfg["unet"]))
    vcfg = M.AutoencoderConfig(**tuples(cfg["vae"]))
    unet = program_module(lambda d: M.UNet2DCondition(ucfg, device=d, dtype=dt), device)
    vae = program_module(lambda d: M.AutoencoderKL(vcfg, device=d, dtype=dt), device)
    fill_seeded(unet, seed, "unet", dt, device)
    fill_seeded(vae, seed, "vae", dt, device)
    for m in unet.modules():
        if isinstance(m, M.Transformer2D):
            m.forward = _ranged(m.forward)
    scale = cfg["cfg_scale"]

    class FixedSDXL(SDXL):
        """SDXL with the fixed conditioning, at the configuration's scale."""

        def eps_fn(self, text_emb=None, cfg_scale=scale, features=False):
            return super().eps_fn(text_emb, cfg_scale, features)

    return Program(FixedSDXL(unet, vae, sched, SDXLText(*conditioning(cfg, seed, device)),
                             device=device))


@dataclasses.dataclass
class SDXLReference(Reference):
    text: Optional[torch.Tensor] = None  # [uncond; cond] context, float32
    pooled: Optional[torch.Tensor] = None  # [uncond; cond] pooled embedding, float32
    time_ids: Optional[torch.Tensor] = None
    cfg_scale: float = 5.0
    codec_tag = "vae"

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        return self.codec.encode_mode(img) * self.scale

    def eps_fn(self):
        return RX.cfg_eps(self.unet, self.text, self.pooled, self.time_ids, self.cfg_scale)

    def unet_once(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t, self.text[:1], self.pooled[:1], self.time_ids[:1])

    def fill(self, cfg: dict, seed: int, device) -> None:
        super().fill(cfg, seed, device)
        text, pooled, self.time_ids = conditioning(cfg, seed, device)
        self.text, self.pooled = text.float(), pooled.float()


def reference_modules(cfg: dict, device) -> SDXLReference:
    with torch.device(device):
        ucfg = RX.SDXLUNetConfig.from_dict(cfg["unet"])
        unet = RX.TorchSDXLUNet(ucfg)
        vcfg = RC.AutoencoderConfig.from_dict(cfg["vae"])
        codec = RM.TorchAutoencoderKL(vcfg, attn_naming="modern")
        text = torch.empty(tuple(cfg["text_embedding"]))
        pooled = torch.empty(tuple(cfg["pooled_embedding"]))
        time_ids = torch.empty(2, len(cfg["time_ids"]))
    return SDXLReference(unet, codec, vcfg.scaling_factor, text=text, pooled=pooled,
                         time_ids=time_ids, cfg_scale=cfg["cfg_scale"])


def tiny() -> dict:
    from diffusion_image_editing_tpu_torch import models as M

    ucfg = M.TINY_SDXL_UNET
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    return dict(unet=config_dict(ucfg),
                vae=config_dict(dataclasses.replace(M.TINY_VAE, sample_size=16)),
                text_embedding=[2, 7, ucfg.cross_attention_dim], pooled_embedding=[2, pooled])
