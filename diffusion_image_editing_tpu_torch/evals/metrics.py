"""Quantitative evaluation: the port of `evals/metrics.py`. PSNR / MSE, and
the anyGAN attribute metrics of the reference's metrics flow: the share of
the 40 CelebA attributes whose argmax prediction survives the edit
(`attribute_consistency`) and the sorted mean per-attribute score deltas
(`avg_increase_decrease_per_attribute`). Images are NCHW in [-1, 1];
generation, edit and prediction run batched."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.constants import ANY_GAN_ATTRS

Predictor = Callable[[torch.Tensor], torch.Tensor]  # images -> (B, 80) logits


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2, dim=tuple(range(1, a.dim())))


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 2.0) -> torch.Tensor:
    """PSNR for [-1, 1] images (dynamic range 2.0), per batch element."""
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse(a, b), min=1e-12))


def predict_attributes(predictor_fn: Predictor, imgs: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) [-1, 1] images -> (B, 40, 2) anyGAN attribute logits."""
    return predictor_fn(imgs).reshape(imgs.shape[0], 40, 2)


def attribute_consistency(
    original_imgs: torch.Tensor,
    edited_imgs: torch.Tensor,
    predictor_fn: Predictor,
    skip_idx: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """Per attribute, the % of samples whose argmax class the edit left
    unchanged. `skip_idx`: attributes intentionally edited, left out."""
    with torch.no_grad():
        p0 = predict_attributes(predictor_fn, original_imgs).argmax(-1).cpu().numpy()
        p1 = predict_attributes(predictor_fn, edited_imgs).argmax(-1).cpu().numpy()
    out = {}
    for i, name in enumerate(ANY_GAN_ATTRS):
        if skip_idx and i in skip_idx:
            continue
        out[name] = float((p0[:, i] == p1[:, i]).mean() * 100.0)
    return out


def avg_increase_decrease_per_attribute(
    original_imgs: torch.Tensor,
    edited_imgs: torch.Tensor,
    predictor_fn: Predictor,
) -> List[Tuple[int, str, float]]:
    """Mean softmax-score delta (edited - original, positive class) per
    attribute, sorted descending."""
    with torch.no_grad():
        s0 = torch.softmax(predict_attributes(predictor_fn, original_imgs).float(), dim=-1)
        s1 = torch.softmax(predict_attributes(predictor_fn, edited_imgs).float(), dim=-1)
        delta = torch.mean(s1[..., 1] - s0[..., 1], dim=0).cpu().numpy()  # (40,)
    order = np.argsort(-delta)
    return [(int(i), ANY_GAN_ATTRS[int(i)], float(delta[int(i)])) for i in order]


def inversion_roundtrip_metrics(
    x0: torch.Tensor, recon: torch.Tensor, lpips_fn: Optional[Callable] = None
) -> Dict[str, float]:
    """The round trip's quality: PSNR and MSE, and LPIPS with `lpips_fn`."""
    with torch.no_grad():
        out = {"psnr": float(torch.mean(psnr(x0, recon))),
               "mse": float(torch.mean(mse(x0, recon)))}
        if lpips_fn is not None:
            out["lpips"] = float(torch.mean(lpips_fn(x0, recon)))
    return out


def run_attribute_evaluation(
    wrapper,
    pipeline,
    predictor_fn: Predictor,
    attr_func,
    n_samples: int = 16,
    num_inference_steps: int = 50,
    eta: float = 0.0,
    seed: int = 0,
    skip_idx: Optional[Sequence[int]] = None,
    inversion: Optional[str] = None,
    t_skip: Optional[int] = None,
    resynthesize: bool = False,
    classes: Optional[Sequence[int]] = None,
    dilate_mask: bool = False,
):
    """The reference's metrics flow: a batched generation -> the guided edit
    -> anyGAN predictions on both -> consistency % and sorted score deltas.

    `inversion=None` edits the generation's own noise maps (the reference's
    flow at eta 1). `inversion="ddpm"` re-inverts the generated images with
    edit-friendly DDPM inversion (its noise from a generator seeded with
    `seed + 1`), then edits from `xts[t_skip]` (default min(36, steps - 1))
    with the extracted zs, with optional resynthesis and a segmentation
    mask over `classes`. The edit's generator is seeded with `seed`."""
    imgs, _, xt, zs = wrapper.generate_images(
        num_images=n_samples, eta=eta, num_inference_steps=num_inference_steps, seed=seed)
    dev = wrapper.device
    if inversion == "ddpm":
        if eta <= 0:
            raise ValueError("edit-friendly evaluation requires eta > 0")
        if t_skip is None:
            t_skip = min(36, num_inference_steps - 1)
        xt, zs, xts, mask, _ = pipeline.prepare_real_image_edit(
            imgs, eta=eta, inversion_method="ddpm", classes=classes, dilate_mask=dilate_mask,
            generator=torch.Generator(device=dev).manual_seed(seed + 1))
        out = pipeline.edit_image(
            xt, eta=eta, zs=zs, xts=xts, mask=mask, attr_func=attr_func,
            inversion_method="ddpm", t_skip=t_skip, resynthesize=resynthesize, collect=False,
            generator=torch.Generator(device=dev).manual_seed(seed))
    elif inversion is None:
        out = pipeline.edit_image(xt, eta=eta, zs=zs, attr_func=attr_func, collect=False,
                                  generator=torch.Generator(device=dev).manual_seed(seed))
    else:
        raise ValueError(f"Unknown inversion: {inversion}")
    edited = out.imgs
    return {
        "attribute_consistency": attribute_consistency(imgs, edited, predictor_fn, skip_idx),
        "score_deltas": avg_increase_decrease_per_attribute(imgs, edited, predictor_fn),
    }
