"""Image resizing and normalisation, NCHW: the port of the JAX package's
`ops/resize.py`, including the hard-threshold mask resize.

`jax.image.resize` antialiases by default (`antialias=True`), whatever the
JAX docstring says: a bilinear downsample there averages over the whole
footprint of each output pixel, not over the two nearest input pixels. So
`resize_bilinear` is `F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`, which matches it; without antialiasing, 148 of the 4096
pixels of a 512 -> 64 hard mask of a blob differ. Upsampling is plain
bilinear either way. `jax.image.resize(method="nearest")` picks the input
pixel whose centre is nearest, which is `mode="nearest-exact"` (plain
"nearest" floors, and differs when downsampling).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NCHW bilinear resize with antialiasing, as `jax.image.resize`."""
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                         antialias=True)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NCHW nearest-neighbour resize, the nearest pixel centre."""
    return F.interpolate(x, size=(height, width), mode="nearest-exact")


def resize_mask_hard(mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize, then a hard threshold to {0, 1}: only pixels whose
    resized value is at least 1 survive.

    The resize runs in f64 and is rounded to f32 before the threshold. A
    pixel whose whole footprint is 1 then lands on exactly 1.0 whatever
    order the weights are summed in, so the card and the CPU give the same
    mask: in f32, the renormalised border weights sum to 1 within an ulp
    either way, and one order can fall below 1.0 and drop the pixel. At
    the power-of-two factors of the path (512 -> 64 image to latent) the
    mask equals the JAX package's f32 one."""
    resized = resize_bilinear(mask.to(torch.float64), height, width).to(torch.float32)
    return (resized >= 1.0).to(mask.dtype)


def imagenet_normalize(x01: torch.Tensor) -> torch.Tensor:
    """Normalise a [0, 1] NCHW image with the ImageNet statistics."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x01.dtype, device=x01.device).view(-1, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x01.dtype, device=x01.device).view(-1, 1, 1)
    return (x01 - mean) / std


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp(x / 2 + 0.5, 0.0, 1.0)


def to_symmetric_range(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return x * 2 - 1
