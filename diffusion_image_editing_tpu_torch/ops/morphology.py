"""Morphological dilation and erosion, NCHW: the port of the JAX package's
`ops/morphology.py`.

Flat (zero-weight) morphology is a window max or min over the kernel with
"same" padding, asymmetric for even kernels ((k - 1) // 2 before, the rest
after), the padding value the dtype's lowest (dilation) or highest
(erosion) value, so that it never wins. The windows are strided views
(`Tensor.unfold`), which take integer tensors as well as floats.

Weighted morphology (`morphology2d`, `Morphology2D`) takes channel-major
k x k patches, zero-padded, as `lax.conv_general_dilated_patches` does:
`F.unfold` orders its features the same way (C, kh, kw).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(kernel_size: int):
    pad_total = kernel_size - 1
    pad_beg = pad_total // 2
    return pad_beg, pad_total - pad_beg


def _extreme(dtype: torch.dtype, lowest: bool):
    if dtype.is_floating_point:
        return -float("inf") if lowest else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lowest else info.max


def _windows(x: torch.Tensor, kernel_size: int, fill) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H, W, k, k) views of the "same"-padded input."""
    beg, end = _same_pads(kernel_size)
    n, c, h, w = x.shape
    padded = torch.full((n, c, h + kernel_size - 1, w + kernel_size - 1), fill, dtype=x.dtype,
                        device=x.device)
    padded[:, :, beg:beg + h, beg:beg + w] = x
    return padded.unfold(2, kernel_size, 1).unfold(3, kernel_size, 1)


def dilate(x: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    """Flat grey-scale or binary dilation of an NCHW tensor: the window max."""
    return _windows(x, kernel_size, _extreme(x.dtype, lowest=True)).amax(dim=(-2, -1))


def erode(x: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    """Flat erosion: the window min."""
    return _windows(x, kernel_size, _extreme(x.dtype, lowest=False)).amin(dim=(-2, -1))


def morphology2d(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    kernel_size: int = 5,
    op: str = "dilation2d",
    soft_max: bool = False,
    beta: float = 15.0,
) -> torch.Tensor:
    """Weighted morphology with an optional soft-max relaxation:
    out[n, o, h, w] = max over (c, k) of (x_patch + w[o, c, k]) for dilation,
    -max (w[o, c, k] - x_patch) for erosion; `soft_max` takes
    logsumexp(beta * scores) / beta in place of the max.

    x: (N, C, H, W); weight: (O, C, k, k) or None (flat, zeros). Returns
    (N, O, H, W)."""
    if op not in ("dilation2d", "erosion2d"):
        raise ValueError(f"Unknown morphology op {op!r}")
    n, c, h, w = x.shape
    beg, end = _same_pads(kernel_size)
    patches = F.unfold(F.pad(x, (beg, end, beg, end)), kernel_size)  # (N, C*k*k, H*W)
    if weight is None:
        weight = torch.zeros((1, c, kernel_size, kernel_size), dtype=x.dtype, device=x.device)
    wf = weight.reshape(weight.shape[0], -1)[None, :, :, None]  # (1, O, C*k*k, 1)
    p = patches[:, None]  # (N, 1, C*k*k, H*W)
    scores = p + wf if op == "dilation2d" else wf - p
    if soft_max:
        out = torch.logsumexp(scores * beta, dim=2) / beta
    else:
        out = scores.amax(dim=2)
    if op == "erosion2d":
        out = -out
    return out.reshape(n, -1, h, w)


class Morphology2D(nn.Module):
    """Trainable morphological layer; its zero-initialised (O, C, k, k)
    weight makes it flat morphology."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 soft_max: bool = True, beta: float = 15.0, op: str = "dilation2d",
                 device=None):
        super().__init__()
        self.kernel_size, self.soft_max, self.beta, self.op = kernel_size, soft_max, beta, op
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return morphology2d(x, self.weight, self.kernel_size, self.op, self.soft_max, self.beta)


class Dilation2D(Morphology2D):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 soft_max: bool = True, beta: float = 15.0, device=None):
        super().__init__(in_channels, out_channels, kernel_size, soft_max, beta, "dilation2d",
                         device)


class Erosion2D(Morphology2D):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 soft_max: bool = True, beta: float = 15.0, device=None):
        super().__init__(in_channels, out_channels, kernel_size, soft_max, beta, "erosion2d",
                         device)
