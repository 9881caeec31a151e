"""Model factory: the port of `pipeline/factory.py::create_diffusion_model`
for the SD family and of `create_segmentation_model`.

Builds the wrapper from an HF-layout checkpoint directory (`unet/`, `vae/`,
`text_encoder/`, and `tokenizer/` when present) through
`models/port.py::load_checkpoint_dir`, or from seeded random weights with a
warning when no directory is given. Nothing is downloaded. The
segmentation model is a face-parsing BiSeNet from its checkpoint file
(`models/port.py::load_bisenet_checkpoint`) or from seeded random weights.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from ..core import resolve_device, schedule_for_model
from ..models import (
    CLIP_VIT_L_14_TEXT,
    SD15_UNET,
    SD_VAE,
    AutoencoderKL,
    BiSeNet,
    CLIPTextEncoder,
    UNet2DCondition,
    load_bisenet_checkpoint,
    load_checkpoint_dir,
)
from ..models.bisenet import SegmentationModel
from .wrappers import SD


def create_diffusion_model(
    name: str,
    sample_clipping: bool = True,
    checkpoint_dir: Optional[str] = None,
    num_inference_steps: int = 50,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> SD:
    """`create_diffusion_model("sd")` with the modules in `dtype` (bf16, the
    port's compute dtype, by default) on `device` (None = CUDA, raising
    without it). "ddpm" and "ldm" come with Queue A item 14. As in the JAX
    package, `sample_clipping` is read by those two families only: SD never
    clips pred-x0."""
    if name in ("ddpm", "ldm"):
        raise NotImplementedError(f"the {name!r} family comes with Queue A item 14")
    if name != "sd":
        raise ValueError(f"Unknown model name: {name}")
    dev = resolve_device(device)
    sched = schedule_for_model(name, num_inference_steps)
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


def _warn_random_init():
    print("WARNING: random-init weights (no checkpoint given)", file=sys.stderr)
