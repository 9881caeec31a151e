"""LPIPS, the perceptual distance of Zhang et al. 2018 with a VGG16
backbone, in torch, NCHW: the port of `evals/lpips.py`, written from
scratch (no torchvision, no lpips package).

The input is shifted and scaled by lpips' constants, the five VGG16 feature
taps (after the ReLUs of conv 1, 3, 6, 9 and 12: relu1_2 ... relu5_3) are
unit-normalised over the channels, and each layer's squared difference is
weighted per channel by its lin head (|w|, as the JAX package), summed over
the channels and averaged over the positions; the five layers add up to a
(B,) distance. The parameters carry torchvision's and lpips' names
(`vgg.features.{p}.weight` at torchvision's index p, `lin{i}.model.1.weight`
of shape (1, C, 1, 1)): `models.port.port_vgg16_lpips` maps the published
files onto them, `state_dict_from_jax(params, "lpips")` the JAX
package's parameters. No weights are in the repository: seeded random weights
give an untrained, deterministic distance. It computes in f32."""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn as nn

from ..core.device import resolve_device

# torchvision's VGG16 conv layout; "M" = 2 x 2 max-pool
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
TAP_AFTER_CONV = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# lpips' input scaling (the released constants)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def conv_positions() -> List[int]:
    """torchvision's `features.{p}` index of each conv (a conv and its ReLU
    take two slots, a max-pool one)."""
    out, pos = [], 0
    for v in VGG16_CFG:
        if v == "M":
            pos += 1
        else:
            out.append(pos)
            pos += 2
    return out


class VGG16Features(nn.Module):
    """VGG16's conv stack up to relu5_3 as torchvision's `features`
    Sequential (conv, ReLU, ..., max-pool); returns the five LPIPS taps."""

    def __init__(self, width_mult: float = 1.0, device=None):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                c = max(int(v * width_mult), 1)
                layers += [nn.Conv2d(cin, c, 3, padding=1, device=device), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)
        self._taps = {conv_positions()[i] + 1 for i in TAP_AFTER_CONV}  # the ReLUs' slots

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x)
        return taps


class _Lin(nn.Module):
    """lpips' `NetLinLayer` layout: `model.1` is the (1, C, 1, 1) head (its
    `model.0`, a dropout, is the identity at inference)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False, device=device))
        nn.init.constant_(self.model[1].weight, 1.0 / channels)


class LPIPS(nn.Module):
    """lpips(a, b) for NCHW images in [-1, 1]; returns (B,) distances in
    f32. `use_lin=False` averages the channels instead of the lin heads.
    Built on `device` (None = CUDA, raising without it) in f32, frozen and
    in eval mode; the default heads weigh each channel 1/C."""

    def __init__(self, width_mult: float = 1.0, use_lin: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vgg = VGG16Features(width_mult, device=device)
        self.use_lin = use_lin
        chans = [self.vgg.features[p].out_channels
                 for p in (conv_positions()[i] for i in TAP_AFTER_CONV)]
        for i, c in enumerate(chans):
            self.add_module(f"lin{i}", _Lin(c, device=device))
        self.register_buffer("shift", torch.tensor(SHIFT, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.eval().requires_grad_(False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.vgg((a.float() - self.shift) / self.scale)
        fb = self.vgg((b.float() - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa * torch.rsqrt(xa.pow(2).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt(xb.pow(2).sum(1, keepdim=True) + 1e-10)
            diff = (na - nb) ** 2
            if self.use_lin:
                w = getattr(self, f"lin{i}").model[1].weight  # (1, C, 1, 1)
                val = (diff * w.abs()).sum(1)
            else:
                val = diff.mean(1)
            total = total + val.mean(dim=(1, 2))
        return total


def make_lpips_fn(module: LPIPS) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """lpips(a, b) -> (B,), usable as `AttrFunc.metric_fn`; (C, H, W)
    inputs are taken as a batch of one."""

    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dim() == 3:
            a = a[None]
        if b.dim() == 3:
            b = b[None]
        return module(a, b)

    return fn

