"""Latent diffusion (CompVis LDM): UNet2D and the VQ autoencoder, plain
(unguided) eps, with an optional anyGAN ResNet-50 attribute classifier in
float32 (weights tagged "unet", "vqvae" and "classifier")."""

from __future__ import annotations

import dataclasses

import torch

from ..harness.models import Program, Reference, config_dict, serve_dtype, tuples
from ..harness.weights import fill_seeded, program_module
from ..reference import configs as RC
from ..reference import diffusion as R
from ..reference import models as RM
from ..reference import resnet as RR

ROWS = 1


def image_size(cfg: dict) -> int:
    return cfg["vqvae"]["sample_size"]


def build_program(cfg: dict, seed: int, device, steps: int) -> Program:
    from diffusion_image_editing_tpu_torch import models as M
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import LDM

    dt = serve_dtype(cfg)
    sched = schedule_for_model("ldm", steps, clip_sample=False)
    ucfg = M.UNet2DConfig(**tuples(cfg["unet"]))
    vcfg = M.AutoencoderConfig(**tuples(cfg["vqvae"]))
    unet = program_module(lambda d: M.UNet2D(ucfg, device=d, dtype=dt), device)
    vq = program_module(lambda d: M.VQModel(vcfg, device=d, dtype=dt), device)
    fill_seeded(unet, seed, "unet", dt, device)
    fill_seeded(vq, seed, "vqvae", dt, device)
    prog = Program(LDM(unet, sched, vq, device=device))
    if "classifier" in cfg:
        from diffusion_image_editing_tpu_torch.ops.resize import imagenet_normalize, to_unit_range

        c = cfg["classifier"]
        clf = program_module(lambda d: M.ResNet50(num_outputs=c["num_outputs"],
                                                  width=c["width"], device=d), device)
        fill_seeded(clf, seed, "classifier", torch.float32, device)
        clf.eval().requires_grad_(False)
        prog.classifier = clf
        prog.clf_apply_fn = lambda img: clf(imagenet_normalize(to_unit_range(img.float())))
    return prog


@dataclasses.dataclass
class LDMReference(Reference):
    codec_tag = "vqvae"

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        return self.codec.encode(img)

    def eps_fn(self):
        return R.plain_eps(self.unet)

    def unet_once(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t)


def reference_modules(cfg: dict, device) -> LDMReference:
    with torch.device(device):
        unet = RM.TorchUNet2D(RC.UNet2DConfig.from_dict(cfg["unet"]), attn_naming="modern")
        vcfg = RC.AutoencoderConfig.from_dict(cfg["vqvae"])
        codec = RM.TorchVQModel(vcfg, attn_naming="modern")
        clf = None
        if "classifier" in cfg:
            clf = RR.ResNet50(RC.ResNet50Config.from_dict(cfg["classifier"]))
    return LDMReference(unet, codec, vcfg.scaling_factor, classifier=clf)


def tiny() -> dict:
    from diffusion_image_editing_tpu_torch import models as M

    return dict(unet=config_dict(M.TINY_UNET2D), vqvae=config_dict(M.TINY_VQVAE),
                classifier={"num_outputs": 80, "width": 8})
