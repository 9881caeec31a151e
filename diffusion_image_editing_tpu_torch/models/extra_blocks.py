"""Extra segmentation blocks on the fused ABN layer, NCHW: the port of
`models/extra_blocks.py` (the reference's InPlace-ABN companion modules,
`src/Segmentation/modules/deeplab.py`, `residual.py`, `dense.py`, `misc.py`;
none is wired into the shipped BiSeNet).

Each ABN is `ops.abn.FusedABNorm` (kernel K8 on the card), in training mode
with batch statistics and in eval mode with the running ones, as the JAX
blocks' `train` flag. Convolutions are torch's, without bias unless the JAX
block has one. Parameter names are the JAX blocks' module names, so
`models.port.state_dict_from_jax(variables, "abn_blocks")` carries their
weights across."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..ops.abn import FusedABNorm


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, dilation: int = 1,
          bias: bool = False, **fk) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias, **fk)


class GlobalAvgPool2d(nn.Module):
    """(B, C, H, W) -> (B, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class DeeplabV3Head(nn.Module):
    """The ASPP head: a 1x1 branch and three dilated 3x3 branches,
    concatenated, ABN, reduced by a 1x1 conv; a global-pooling branch added
    to it; ABN; with `num_classes`, a 1x1 classifier plus the pooled
    branch's class bias."""

    def __init__(self, in_channels: int, hidden_channels: int = 256, out_channels: int = 256,
                 num_classes: Optional[int] = None, dilations: Tuple[int, int, int] = (12, 24, 36),
                 norm_activation: str = "leaky_relu", device=None):
        super().__init__()
        fk = dict(device=resolve_device(device))
        h = hidden_channels
        self.map_conv_0 = _conv(in_channels, h, **fk)
        for i, d in enumerate(dilations, start=1):
            setattr(self, f"map_conv_{i}", _conv(in_channels, h, 3, dilation=d, **fk))
        self.n_maps = 1 + len(dilations)
        self.map_bn = FusedABNorm(h * self.n_maps, activation=norm_activation, **fk)
        self.red_conv = _conv(h * self.n_maps, out_channels, **fk)
        self.global_pooling_conv = _conv(in_channels, h, **fk)
        self.global_pooling_bn = FusedABNorm(h, activation=norm_activation, **fk)
        self.pool_red_conv = _conv(h, out_channels, **fk)
        self.red_bn = FusedABNorm(out_channels, activation=norm_activation, **fk)
        self.num_classes = num_classes
        if num_classes is not None:
            self.cls_conv = _conv(out_channels, num_classes, bias=True, **fk)
            self.pool_cls_conv = _conv(h, num_classes, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        maps = [getattr(self, f"map_conv_{i}")(x) for i in range(self.n_maps)]
        out = self.red_conv(self.map_bn(torch.cat(maps, dim=1)))
        pool = self.global_pooling_bn(self.global_pooling_conv(x.mean(dim=(2, 3), keepdim=True)))
        out = self.red_bn(out + self.pool_red_conv(pool))
        if self.num_classes is not None:
            out = self.cls_conv(out) + self.pool_cls_conv(pool)
        return out


class IdentityResidualBlock(nn.Module):
    """Pre-activation residual block, a 2-conv (3x3, 3x3) or 3-conv (1x1,
    3x3, 1x1) body; the shortcut is a 1x1 conv of the first ABN's output
    when the channels or the stride change."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (64, 64), stride: int = 1,
                 dilation: int = 1, norm_activation: str = "leaky_relu", device=None):
        super().__init__()
        if len(channels) not in (2, 3):
            raise ValueError("channels must have length 2 or 3")
        fk = dict(device=resolve_device(device))
        act, d = norm_activation, dilation
        self.channels = tuple(channels)
        self.bn1 = FusedABNorm(in_channels, activation=act, **fk)
        self.proj_conv = (_conv(in_channels, channels[-1], stride=stride, **fk)
                          if in_channels != channels[-1] or stride != 1 else None)
        if len(channels) == 2:
            self.conv1 = _conv(in_channels, channels[0], 3, stride, d, **fk)
            self.bn2 = FusedABNorm(channels[0], activation=act, **fk)
            self.conv2 = _conv(channels[0], channels[1], 3, 1, d, **fk)
        else:
            self.conv1 = _conv(in_channels, channels[0], 1, stride, **fk)
            self.bn2 = FusedABNorm(channels[0], activation=act, **fk)
            self.conv2 = _conv(channels[0], channels[1], 3, 1, d, **fk)
            self.bn3 = FusedABNorm(channels[1], activation=act, **fk)
            self.conv3 = _conv(channels[1], channels[2], **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn1 = self.bn1(x)
        shortcut = self.proj_conv(bn1) if self.proj_conv is not None else x
        h = self.conv2(self.bn2(self.conv1(bn1)))
        if len(self.channels) == 3:
            h = self.conv3(self.bn3(h))
        return h + shortcut


class DenseModule(nn.Module):
    """DenseNet-style module: `layers` times ABN -> 3x3 conv of `growth`
    channels, each concatenated to the features."""

    def __init__(self, in_channels: int, growth: int = 32, layers: int = 4,
                 norm_activation: str = "leaky_relu", device=None):
        super().__init__()
        fk = dict(device=resolve_device(device))
        self.layers = layers
        for i in range(layers):
            c = in_channels + i * growth
            setattr(self, f"bn_{i}", FusedABNorm(c, activation=norm_activation, **fk))
            setattr(self, f"conv_{i}", _conv(c, growth, 3, **fk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for i in range(self.layers):
            h = getattr(self, f"conv_{i}")(getattr(self, f"bn_{i}")(feats))
            feats = torch.cat([feats, h], dim=1)
        return feats
