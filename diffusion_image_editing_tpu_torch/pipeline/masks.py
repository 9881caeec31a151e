"""Mask helpers: the port of `pipeline/masks.py`.

`MaskCreator`: parsing map -> one binary mask a class -> their sum ->
optional 7 x 7 dilation -> hard-threshold resize -> a 3-channel NCHW mask.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.morphology import dilate
from ..ops.resize import resize_mask_hard


def apply_mask(mask: torch.Tensor, zo: torch.Tensor, zv: torch.Tensor) -> torch.Tensor:
    """mask * zv + (1 - mask) * zo: zv inside the mask, zo outside."""
    return mask * zv + (1.0 - mask) * zo


class MaskCreator:
    def __init__(self, dilate_mask: bool = True, resize_size: Tuple[int, int] = (256, 256),
                 dilation_kernel: int = 7) -> None:
        self.dilate_mask = dilate_mask
        self.resize_size = resize_size
        self.dilation_kernel = dilation_kernel

    def create_class_mask(self, parsing: torch.Tensor, class_label: int) -> torch.Tensor:
        """(H, W) parsing -> (H, W) f32 mask of the class, optionally dilated."""
        mask = (parsing == class_label).to(torch.float32)
        if self.dilate_mask:
            mask = dilate(mask[None, None], self.dilation_kernel)[0, 0]
        return mask

    def create_mask(self, parsing: torch.Tensor, classes: Sequence[int]) -> torch.Tensor:
        """(H, W) parsing + class ids -> (1, 3, h, w) binary mask."""
        mask = sum(self.create_class_mask(parsing, c) for c in classes)
        mask = resize_mask_hard(mask[None, None], *self.resize_size)
        return mask.repeat(1, 3, 1, 1)
