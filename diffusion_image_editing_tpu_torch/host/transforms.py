"""Host-side PIL <-> tensor codecs (NCHW, [-1, 1]): the port's own copy of
the JAX package's `host/transforms.py`, in the port's NCHW layout.

`tensor_to_pil` takes 2-D masks, (C, H, W) images and batch-of-1
(1, C, H, W) images; `pil_to_tensor` maps PIL images to a (B, 3, H, W) f32
tensor in [-1, 1]. PIL is imported when a codec is called, not with the
module.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _as_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def tensor_to_pil(x):
    """[-1, 1] float (C, H, W) / (1, C, H, W) image, or 2-D mask -> PIL."""
    from PIL import Image

    a = _as_numpy(x)
    if a.ndim == 4:
        assert a.shape[0] == 1, "batched input must have batch size 1"
        a = a[0]
    if a.ndim == 2:
        return Image.fromarray(a.astype(np.uint8))
    if a.ndim == 3:
        a = np.clip(a.transpose(1, 2, 0) / 2 + 0.5, 0.0, 1.0)
        a = (a * 255).round().astype(np.uint8)
        if a.shape[-1] == 1:
            a = a[..., 0]
        return Image.fromarray(a)
    raise ValueError("Input array has wrong shape")


def tensors_to_pils(x) -> List:
    """One PIL image per batch element of a (B, C, H, W) tensor."""
    a = _as_numpy(x)
    if a.ndim == 4:
        return [tensor_to_pil(img) for img in a]
    return [tensor_to_pil(a)]


def pil_to_tensor(pil_imgs) -> torch.Tensor:
    """PIL image or list of them -> (B, 3, H, W) float32 in [-1, 1]."""
    from PIL import Image

    def one(img) -> np.ndarray:
        a = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return (a * 2.0 - 1.0).transpose(2, 0, 1)

    if isinstance(pil_imgs, Image.Image):
        return torch.from_numpy(np.ascontiguousarray(one(pil_imgs)[None]))
    if isinstance(pil_imgs, list):
        return torch.from_numpy(np.stack([one(im) for im in pil_imgs]))
    raise ValueError("Input must be PIL.Image or list of PIL.Image")
