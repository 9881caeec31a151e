"""3x3 convolution, NCHW: `F.conv2d` through cuDNN, the JAX package's
default `xla` mode. Its shift9 and int8 modes come in a later slice."""

from __future__ import annotations

import torch.nn as nn


class Conv3x3(nn.Conv2d):
    """Stride 1, SAME padding; weight (O, I, 3, 3) under diffusers' key names."""

    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__(in_channels, out_channels, 3, padding=1, **factory)
