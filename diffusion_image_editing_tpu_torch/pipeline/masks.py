"""Mask helpers: the port of `pipeline/masks.py` (`apply_mask`; the
segmentation mask creator comes with Queue A item 15a)."""

from __future__ import annotations

import torch


def apply_mask(mask: torch.Tensor, zo: torch.Tensor, zv: torch.Tensor) -> torch.Tensor:
    """mask * zv + (1 - mask) * zo: zv inside the mask, zo outside."""
    return mask * zv + (1.0 - mask) * zo
