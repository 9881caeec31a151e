"""Builds a configuration's models on both sides from its file
(`benchmark/configs/<name>.json`): the program's modules and wrapper, in
the dtype the configuration serves, and the float32 reference modules, each
filled with the same seeded weights.

Families: "sd" (UNet2DCondition + KL VAE, classifier-free guidance over a
fixed [uncond; cond] text embedding made from the seed in place of the
CLIP text encoder) and "ldm" (UNet2D + VQ autoencoder, with an optional
anyGAN ResNet-50 attribute classifier in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..reference import configs as RC
from ..reference import models as RM
from ..reference import resnet as RR
from .weights import fill_seeded, mix_seed, program_module

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def serve_dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def text_embedding(cfg: dict, seed: int, device) -> torch.Tensor:
    """The fixed [uncond; cond] embedding, (2, L, D), in the served dtype."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, "text_embedding"))
    return torch.randn(tuple(cfg["text_embedding"]), generator=gen, device=device,
                       dtype=serve_dtype(cfg))


@dataclasses.dataclass
class Program:
    wrapper: object  # the port's DiffusionWrapper
    classifier: Optional[torch.nn.Module] = None
    clf_apply_fn: Optional[object] = None


def build_program(cfg: dict, seed: int, device, steps: int) -> Program:
    """The port's wrapper for `cfg` at `steps` inference steps, weights from
    `seed`."""
    from diffusion_image_editing_tpu_torch import models as M
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import LDM, SD

    dt = serve_dtype(cfg)
    fam = cfg["family"]
    sched = schedule_for_model(fam, steps, clip_sample=False)
    if fam == "sd":
        ucfg = M.UNet2DConditionConfig(**_tuples(cfg["unet"]))
        vcfg = M.AutoencoderConfig(**_tuples(cfg["vae"]))
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
    if fam == "ldm":
        ucfg = M.UNet2DConfig(**_tuples(cfg["unet"]))
        vcfg = M.AutoencoderConfig(**_tuples(cfg["vqvae"]))
        unet = program_module(lambda d: M.UNet2D(ucfg, device=d, dtype=dt), device)
        vq = program_module(lambda d: M.VQModel(vcfg, device=d, dtype=dt), device)
        fill_seeded(unet, seed, "unet", dt, device)
        fill_seeded(vq, seed, "vqvae", dt, device)
        prog = Program(LDM(unet, sched, vq, device=device))
        if "classifier" in cfg:
            from diffusion_image_editing_tpu_torch.ops.resize import (
                imagenet_normalize, to_unit_range)

            c = cfg["classifier"]
            clf = program_module(lambda d: M.ResNet50(num_outputs=c["num_outputs"],
                                                      width=c["width"], device=d), device)
            fill_seeded(clf, seed, "classifier", torch.float32, device)
            clf.eval().requires_grad_(False)
            prog.classifier = clf
            prog.clf_apply_fn = lambda img: clf(imagenet_normalize(to_unit_range(img.float())))
        return prog
    raise ValueError(f"unknown family {fam!r}")


@dataclasses.dataclass
class Reference:
    family: str
    unet: torch.nn.Module
    codec: torch.nn.Module
    scale: float
    classifier: Optional[torch.nn.Module] = None
    text: Optional[torch.Tensor] = None
    cfg_scale: float = 3.5

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        if self.family == "sd":
            return self.codec.encode_mode(img) * self.scale
        return self.codec.encode(img)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.codec.decode(z / self.scale)


def reference_modules(cfg: dict, device) -> Reference:
    """The float32 reference modules of `cfg` on `device`, not yet filled
    (the meta device gives shapes only, for counting FLOPs)."""
    fam = cfg["family"]
    with torch.device(device):
        if fam == "sd":
            unet = RM.TorchUNet2DCondition(RC.UNet2DConditionConfig.from_dict(cfg["unet"]))
            vcfg = RC.AutoencoderConfig.from_dict(cfg["vae"])
            codec = RM.TorchAutoencoderKL(vcfg, attn_naming="modern")
            return Reference(fam, unet, codec, vcfg.scaling_factor,
                             cfg_scale=cfg.get("cfg_scale", 3.5))
        unet = RM.TorchUNet2D(RC.UNet2DConfig.from_dict(cfg["unet"]), attn_naming="modern")
        vcfg = RC.AutoencoderConfig.from_dict(cfg["vqvae"])
        codec = RM.TorchVQModel(vcfg, attn_naming="modern")
        clf = None
        if "classifier" in cfg:
            clf = RR.ResNet50(RC.ResNet50Config.from_dict(cfg["classifier"]))
        return Reference(fam, unet, codec, vcfg.scaling_factor, classifier=clf)


def build_reference(cfg: dict, seed: int, device) -> Reference:
    """The reference of `cfg` with the program's seeded weights, float32,
    eval mode, no parameter gradients."""
    ref = reference_modules(cfg, "meta")
    for name in ("unet", "codec", "classifier"):
        if getattr(ref, name) is not None:
            setattr(ref, name, getattr(ref, name).to_empty(device=device))
    dt = serve_dtype(cfg)
    fill_seeded(ref.unet, seed, "unet", dt, device)
    fill_seeded(ref.codec, seed, "vae" if ref.family == "sd" else "vqvae", dt, device)
    mods = [ref.unet, ref.codec]
    if ref.classifier is not None:
        fill_seeded(ref.classifier, seed, "classifier", torch.float32, device)
        mods.append(ref.classifier)
    for m in mods:
        m.float().eval().requires_grad_(False)
    if ref.family == "sd":
        ref.text = text_embedding(cfg, seed, device).float()
    return ref


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
