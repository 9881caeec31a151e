"""ResNet backbones, NCHW: the port of the JAX package's `models/resnet.py`
(`NormAct`, `max_pool_3x3_s2`, `BasicBlock`, `Resnet18Features` for BiSeNet;
`Bottleneck`, `ResNet50` for the anyGAN attribute predictor).

Module names follow the torch attribute paths of the face-parsing
checkpoint (`layer2.0.downsample.1.running_var`) and of torchvision's
ResNet-50 (`layer3.5.conv3.weight`, `fc.bias`), so their state dicts load
with `load_state_dict` into `norm="bn"`. A `NormAct` holds its norm's
parameters and buffers itself, as the checkpoints' BatchNorm2d does.

Mixed precision as in the JAX package: `dtype` is the conv COMPUTE dtype.
Convs cast their input and weight to it; parameters and norm statistics
stay f32, and a norm upcasts its input to f32 and casts its output back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.abn import FusedABNorm

NORMS = ("bn", "abn", "abn_sync")


class Conv(nn.Conv2d):
    """Conv2d without bias that computes in `compute_dtype` (Flax's
    `nn.Conv(dtype=...)`): input and f32 weight are cast to it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, compute_dtype: torch.dtype = torch.float32, **factory):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=False,
                         **factory)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class NormAct(FusedABNorm):
    """BatchNorm (+ ReLU) or fused ABN (+ leaky ReLU), selected by `norm`.

    `norm="bn"` has Flax's BatchNorm semantics, not torch's: statistics
    E[x^2] - mean^2 in f32, and the running variance takes the BIASED batch
    variance, running = 0.9 * running + 0.1 * batch, eps 1e-5. The buffer
    `num_batches_tracked` is there for the checkpoint's keys. `norm="abn"`
    is `ops.abn.fused_abn` (K8 on the card) with activation leaky_relu when
    `act` is set and identity otherwise. `abn_sync` needs torch.distributed
    and is not ported yet (ROADMAP Queue A item 18)."""

    def __init__(self, num_features: int, norm: str = "bn", act: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        if norm not in NORMS:
            raise ValueError(f"Unknown norm {norm!r}; have {NORMS}")
        super().__init__(num_features, activation="leaky_relu" if act else "identity",
                         axis_name="dp" if norm == "abn_sync" else None, device=device)
        self.norm, self.act, self.dtype = norm, act, dtype
        if norm == "bn":
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.norm == "bn":
            out = self._batch_norm(x)
            out = torch.relu(out) if self.act else out
        else:
            out = super().forward(x)
        return out.to(self.dtype)

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
                self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


class BasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(compute_dtype=dtype, device=device)
        self.conv1 = Conv(in_chan, out_chan, 3, stride, 1, **kw)
        self.bn1 = NormAct(out_chan, norm, True, dtype, device)
        self.conv2 = Conv(out_chan, out_chan, 3, 1, 1, **kw)
        self.bn2 = NormAct(out_chan, norm, False, dtype, device)
        self.downsample = None
        if in_chan != out_chan or stride != 1:
            self.downsample = nn.Sequential(Conv(in_chan, out_chan, 1, stride, 0, **kw),
                                            NormAct(out_chan, norm, False, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(shortcut.to(self.dtype) + r)


class Resnet18Features(nn.Module):
    """Returns (feat8, feat16, feat32) of widths (2, 4, 8) * `width`."""

    def __init__(self, norm: str = "bn", width: int = 64, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        w = width
        self.conv1 = Conv(3, w, 7, 2, 3, compute_dtype=dtype, device=device)
        self.bn1 = NormAct(w, norm, True, dtype, device)

        def layer(cin, cout, stride):
            return nn.Sequential(BasicBlock(cin, cout, stride, norm, dtype, device),
                                 BasicBlock(cout, cout, 1, norm, dtype, device))

        self.layer1 = layer(w, w, 1)
        self.layer2 = layer(w, 2 * w, 2)
        self.layer3 = layer(2 * w, 4 * w, 2)
        self.layer4 = layer(4 * w, 8 * w, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = max_pool_3x3_s2(self.bn1(self.conv1(x)))
        f8 = self.layer2(self.layer1(h))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


class Bottleneck(nn.Module):
    """torchvision's ResNet-50 block (stride on the 3 x 3 conv), f32."""

    def __init__(self, in_chan: int, planes: int, stride: int = 1, downsample: bool = False,
                 norm: str = "bn", device=None):
        super().__init__()
        self.conv1 = Conv(in_chan, planes, 1, device=device)
        self.bn1 = NormAct(planes, norm, True, device=device)
        self.conv2 = Conv(planes, planes, 3, stride, 1, device=device)
        self.bn2 = NormAct(planes, norm, True, device=device)
        self.conv3 = Conv(planes, planes * 4, 1, device=device)
        self.bn3 = NormAct(planes * 4, norm, False, device=device)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(Conv(in_chan, planes * 4, 1, stride, device=device),
                                            NormAct(planes * 4, norm, False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(shortcut + out)


class ResNet50(nn.Module):
    """torchvision-style ResNet-50 with a head of `num_outputs` (the anyGAN
    attribute predictor: 40 attributes x 2 logits), f32, NCHW. `width`
    shrinks it for tests (64 is torchvision's)."""

    def __init__(self, num_outputs: int = 80, norm: str = "bn", width: int = 64, device=None):
        super().__init__()
        self.width = w = width
        self.conv1 = Conv(3, w, 7, 2, 3, device=device)
        self.bn1 = NormAct(w, norm, True, device=device)
        cin = w
        for i, (planes, blocks, stride) in enumerate(
                [(w, 3, 1), (w * 2, 4, 2), (w * 4, 6, 2), (w * 8, 3, 2)], start=1):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if j == 0 else 1, j == 0, norm,
                                        device))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        self.fc = nn.Linear(cin, num_outputs, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = max_pool_3x3_s2(self.bn1(self.conv1(x.float())))
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.fc(h.mean(dim=(2, 3)))


def norm_layers(module: nn.Module, norm: Optional[str] = None):
    """The module's NormAct layers (of one `norm`, or all)."""
    return [m for m in module.modules()
            if isinstance(m, NormAct) and (norm is None or m.norm == norm)]
