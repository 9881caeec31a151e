"""Model factory: the port of `pipeline/factory.py`'s
`create_diffusion_model`, `create_segmentation_model` and
`get_pretrained_anygan`.

Builds the wrapper from an HF-layout checkpoint directory through
`models/port.py::load_checkpoint_dir` (DDPM: `unet/`; LDM: `unet/` and
`vqvae/`; SD: `unet/`, `vae/`, `text_encoder/`, and `tokenizer/` when
present), or from seeded random weights with a warning when no directory is
given. Nothing is downloaded. The segmentation model is a face-parsing
BiSeNet from its checkpoint file (`models/port.py::load_bisenet_checkpoint`)
or from seeded random weights; the anyGAN attribute predictor a ResNet-50
from its `.pth` (`models/port.py::load_anygan_checkpoint`) or from seeded
random weights.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional, Tuple

import torch

from ..core import resolve_device, schedule_for_model
from ..models import (
    CLIP_VIT_L_14_TEXT,
    DDPM_CELEBAHQ_256,
    LDM_CELEBAHQ_256_UNET,
    LDM_CELEBAHQ_VQVAE,
    SD15_UNET,
    SD_VAE,
    AutoencoderKL,
    BiSeNet,
    CLIPTextEncoder,
    ResNet50,
    UNet2D,
    UNet2DCondition,
    VQModel,
    load_anygan_checkpoint,
    load_bisenet_checkpoint,
    load_checkpoint_dir,
)
from ..models.bisenet import SegmentationModel
from .wrappers import DDPM, LDM, SD, DiffusionWrapper


def create_diffusion_model(
    name: str,
    sample_clipping: bool = True,
    checkpoint_dir: Optional[str] = None,
    num_inference_steps: int = 50,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> DiffusionWrapper:
    """`create_diffusion_model("ddpm"|"ldm"|"sd")` with the modules in
    `dtype` (bf16, the port's compute dtype, by default) on `device` (None =
    CUDA, raising without it). As in the JAX package, `sample_clipping` is
    read by "ddpm" and "ldm" only (True for synthetic generation, False for
    real-image editing): SD never clips pred-x0."""
    if name not in ("ddpm", "ldm", "sd"):
        raise ValueError(f"Unknown model name: {name}")
    dev = resolve_device(device)
    sched = schedule_for_model(name, num_inference_steps,
                               sample_clipping if name in ("ddpm", "ldm") else None)
    if name in ("ddpm", "ldm"):
        return _unconditional(name, sched, checkpoint_dir, dtype, dev)
    if checkpoint_dir is not None:
        unet = load_checkpoint_dir(os.path.join(checkpoint_dir, "unet"), "unet2d_cond", dev,
                                   dtype)
        vae = load_checkpoint_dir(os.path.join(checkpoint_dir, "vae"), "vae", dev, dtype)
        text = load_checkpoint_dir(os.path.join(checkpoint_dir, "text_encoder"), "clip_text",
                                   dev, dtype)
        tokenizer = None
        tok_dir = os.path.join(checkpoint_dir, "tokenizer")
        if os.path.isdir(tok_dir):
            from ..host.tokenizer import CLIPTokenizer

            tokenizer = CLIPTokenizer.from_pretrained(tok_dir)
        return SD(unet, vae, sched, text, tokenizer, device=dev)
    _warn_random_init()
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(0)
        unet = UNet2DCondition(SD15_UNET, device=dev, dtype=dtype)
        vae = AutoencoderKL(SD_VAE, device=dev, dtype=dtype)
        text = CLIPTextEncoder(CLIP_VIT_L_14_TEXT, device=dev, dtype=dtype)
    return SD(unet, vae, sched, text, None, device=dev)


def _unconditional(name, sched, checkpoint_dir, dtype, dev) -> DiffusionWrapper:
    """DDPM (`unet/`) or LDM (`unet/` and `vqvae/`)."""
    if checkpoint_dir is not None:
        unet = load_checkpoint_dir(os.path.join(checkpoint_dir, "unet"), "unet2d", dev, dtype)
        if name == "ddpm":
            return DDPM(unet, sched, device=dev)
        vq = load_checkpoint_dir(os.path.join(checkpoint_dir, "vqvae"), "vq", dev, dtype)
        return LDM(unet, sched, vq, device=dev)
    _warn_random_init()
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(0)
        if name == "ddpm":
            return DDPM(UNet2D(DDPM_CELEBAHQ_256, device=dev, dtype=dtype), sched, device=dev)
        unet = UNet2D(LDM_CELEBAHQ_256_UNET, device=dev, dtype=dtype)
        vq = VQModel(LDM_CELEBAHQ_VQVAE, device=dev, dtype=dtype)
    return LDM(unet, sched, vq, device=dev)


def create_segmentation_model(checkpoint_path: Optional[str] = None, n_classes: int = 19,
                              width: int = 64, device=None) -> SegmentationModel:
    """A `SegmentationModel` of a face-parsing `BiSeNet(norm="bn")`, f32, on
    `device` (None = CUDA, raising without it): loaded from
    `checkpoint_path`, whose classes and width must be `n_classes` and
    `width`, or seeded random weights with a warning."""
    dev = resolve_device(device)
    if checkpoint_path is not None:
        module = load_bisenet_checkpoint(checkpoint_path, dev)
        if (module.n_classes, module.width) != (n_classes, width):
            raise ValueError(f"{checkpoint_path} holds a BiSeNet of {module.n_classes} classes "
                             f"and width {module.width}, not {n_classes} and {width}")
        return SegmentationModel(module)
    _warn_random_init()
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(0)
        module = BiSeNet(n_classes=n_classes, norm="bn", width=width, device=dev)
    return SegmentationModel(module)


def get_pretrained_anygan(checkpoint_path: Optional[str] = None, width: int = 64,
                          device=None) -> Tuple[Callable[[torch.Tensor], torch.Tensor], ResNet50]:
    """The anyGAN attribute predictor, a ResNet-50 with 80 logits (40
    attributes x 2), f32, in eval mode, on `device` (None = CUDA, raising
    without it): loaded from `checkpoint_path`, whose width must be `width`,
    or seeded random weights with a warning. Returns (apply_fn, module):
    apply_fn maps an NCHW image batch (ImageNet-normalised, as the caller
    prepares it) to its (B, 80) logits. (The JAX package returns the
    variables beside its apply function; here they live in the module.)"""
    dev = resolve_device(device)
    if checkpoint_path is not None:
        module = load_anygan_checkpoint(checkpoint_path, dev)
        if module.width != width:
            raise ValueError(f"{checkpoint_path} holds a ResNet-50 of width {module.width}, "
                             f"not {width}")
    else:
        _warn_random_init()
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(0)
            module = ResNet50(num_outputs=80, width=width, device=dev).eval()
    module.requires_grad_(False)

    def apply_fn(imgs: torch.Tensor) -> torch.Tensor:
        return module(imgs)

    return apply_fn, module


def _warn_random_init():
    print("WARNING: random-init weights (no checkpoint given)", file=sys.stderr)
