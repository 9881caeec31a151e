"""BiSeNet face-parsing network, NCHW: the port of the JAX package's
`models/bisenet.py` (ContextPath on ResNet-18 with two attention refinement
modules and global context, the stride-8 ResNet feature in place of a
spatial path, FeatureFusionModule, three output heads upsampled to the
input size, the heads in f32), and `SegmentationModel`, the inference
wrapper that turns an image into a parsing map and gives segmentation
guidance its differentiable logits.

Module names follow the face-parsing checkpoint's torch keys
(`cp.arm16.conv.bn.weight`, `cp.resnet.layer2.0.downsample.1.running_var`),
which the JAX package's `models/port.py` reads, so that checkpoint loads
into `BiSeNet(norm="bn")` with `load_state_dict`. `dtype` is the conv
COMPUTE dtype; parameters and norm statistics stay f32 (see `NormAct`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import imagenet_normalize, resize_bilinear, to_unit_range
from .resnet import Conv, NormAct, Resnet18Features


def resize_bilinear_align_corners(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True."""
    if tuple(x.shape[2:]) == (h_out, w_out):
        return x
    return F.interpolate(x, size=(h_out, w_out), mode="bilinear", align_corners=True)


def upsample_nearest(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Nearest upsample to (h_out, w_out): whole factors repeat each pixel
    (every size BiSeNet meets at 2x); others pick the pixel whose centre is
    nearest, as `jax.image.resize(method="nearest")` does."""
    n, c, h, w = x.shape
    if (h_out, w_out) == (h, w):
        return x
    if h_out % h == 0 and w_out % w == 0:
        kh, kw = h_out // h, w_out // w
        return x[:, :, :, None, :, None].expand(n, c, h, kh, w, kw).reshape(n, c, h_out, w_out)
    return F.interpolate(x, size=(h_out, w_out), mode="nearest-exact")


class ConvBNReLU(nn.Module):
    """conv (no bias) -> NormAct with its activation."""

    def __init__(self, in_chan: int, out_chan: int, ks: int = 3, stride: int = 1,
                 padding: int = 1, norm: str = "bn", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.conv = Conv(in_chan, out_chan, ks, stride, padding, compute_dtype=dtype,
                         device=device)
        self.bn = NormAct(out_chan, norm, True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BiSeNetOutput(nn.Module):
    """ConvBNReLU -> 1x1 conv to n_classes; logits in f32 for the loss."""

    def __init__(self, in_chan: int, mid_chan: int, n_classes: int, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan, 3, 1, 1, norm, dtype, device)
        self.conv_out = Conv(mid_chan, n_classes, 1, compute_dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x)).float()


class AttentionRefinementModule(nn.Module):
    """feat * sigmoid(norm(1x1(mean over H, W of feat)))."""

    def __init__(self, in_chan: int, out_chan: int, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan, 3, 1, 1, norm, dtype, device)
        self.conv_atten = Conv(out_chan, out_chan, 1, compute_dtype=dtype, device=device)
        self.bn_atten = NormAct(out_chan, norm, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean((2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    """ResNet-18 + ARMs + global context; returns (feat8, cp8, cp16)."""

    def __init__(self, norm: str = "bn", width: int = 64, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        w = width
        self.resnet = Resnet18Features(norm, w, dtype, device)
        self.arm16 = AttentionRefinementModule(4 * w, 2 * w, norm, dtype, device)
        self.arm32 = AttentionRefinementModule(8 * w, 2 * w, norm, dtype, device)
        self.conv_head32 = ConvBNReLU(2 * w, 2 * w, 3, 1, 1, norm, dtype, device)
        self.conv_head16 = ConvBNReLU(2 * w, 2 * w, 3, 1, 1, norm, dtype, device)
        self.conv_avg = ConvBNReLU(8 * w, 2 * w, 1, 1, 0, norm, dtype, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feat8, feat16, feat32 = self.resnet(x)
        h16, w16 = feat16.shape[2:]
        h8, w8 = feat8.shape[2:]
        avg = self.conv_avg(feat32.mean((2, 3), keepdim=True))
        f32_sum = self.arm32(feat32) + avg  # avg broadcasts over H, W
        f32_up = self.conv_head32(upsample_nearest(f32_sum, h16, w16))
        f16_sum = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(upsample_nearest(f16_sum, h8, w8))
        return feat8, f16_up, f32_up


class FeatureFusionModule(nn.Module):
    """Concat + 1x1 ConvBNReLU + squeeze-excite gate."""

    def __init__(self, in_chan: int, out_chan: int, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.convblk = ConvBNReLU(in_chan, out_chan, 1, 1, 0, norm, dtype, device)
        self.conv1 = Conv(out_chan, out_chan // 4, 1, compute_dtype=dtype, device=device)
        self.conv2 = Conv(out_chan // 4, out_chan, 1, compute_dtype=dtype, device=device)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp.to(self.dtype), fcp.to(self.dtype)], dim=1))
        atten = torch.relu(self.conv1(feat.mean((2, 3), keepdim=True)))
        atten = torch.sigmoid(self.conv2(atten))
        return feat * atten + feat


class BiSeNet(nn.Module):
    """Three heads, (B, n_classes, H, W) f32 each, upsampled to the input."""

    def __init__(self, n_classes: int = 19, norm: str = "bn", width: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        w = width
        self.n_classes, self.norm, self.width, self.dtype = n_classes, norm, width, dtype
        self.cp = ContextPath(norm, w, dtype, device)
        self.ffm = FeatureFusionModule(4 * w, 4 * w, norm, dtype, device)
        self.conv_out = BiSeNetOutput(4 * w, 4 * w, n_classes, norm, dtype, device)
        self.conv_out16 = BiSeNetOutput(2 * w, w, n_classes, norm, dtype, device)
        self.conv_out32 = BiSeNetOutput(2 * w, w, n_classes, norm, dtype, device)

    def forward(self, x: torch.Tensor):
        h0, w0 = x.shape[2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        feat_fuse = self.ffm(feat_res8, feat_cp8)
        out = self.conv_out(feat_fuse)
        out16 = self.conv_out16(feat_cp8)
        out32 = self.conv_out32(feat_cp16)
        return tuple(resize_bilinear_align_corners(o, h0, w0) for o in (out, out16, out32))


class SegmentationModel:
    """Inference wrapper of a BiSeNet: a (B, 3, H, W) image in [-1, 1] ->
    bilinear resize to `image_size` -> [0, 1] -> ImageNet normalisation ->
    BiSeNet -> the (H, W) argmax of the first image's first head: the
    parsing map, at `image_size`.

    It keeps its module, in eval mode and frozen, with its own parameters:
    unlike the JAX package's `logits_fn(params, img)`, `logits_fn` takes no
    parameters."""

    def __init__(self, module: BiSeNet, image_size: int = 512):
        self.module = module.eval().requires_grad_(False)
        self.image_size = image_size
        self.device = next(module.parameters()).device

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(img.to(self.device), self.image_size, self.image_size)
        x = imagenet_normalize(to_unit_range(x))
        return self.module(x)[0][0].argmax(dim=0)

    def logits_fn(self, img: torch.Tensor) -> torch.Tensor:
        """Differentiable first-head logits (B, n_classes, H, W) of an image
        the caller has already normalised: no resize, no normalisation."""
        return self.module(img)[0]
