"""Segmentation losses over NCHW logits: OHEM cross-entropy, softmax focal
loss and plain CE, the port of the JAX package's `seg/losses.py`.

Ignored pixels (label 255) carry 0 loss. In OHEM they stay in the vector of
per-pixel losses, as in the torch original: they may enter the top-n_min
mean as zeros but never exceed the threshold.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IGNORE_LABEL = 255


def _kth_largest_nonneg(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest (1-indexed, duplicates counted) of a non-negative
    f32 vector, as a 0-d tensor on its device: binary search on the float
    bit pattern (non-negative IEEE floats order like their int32 bits), 31
    counting passes and no sort, and no wait for the device. The value is
    the one a sort gives. `torch.kthvalue` at the trainer's 3.2 M losses ran
    one block a call on the H100, about 17 ms."""
    bits = flat.contiguous().view(torch.int32)
    lo = torch.zeros((), dtype=torch.int32, device=flat.device)
    hi = torch.full((), 0x7F800000, dtype=torch.int32, device=flat.device)  # +inf
    for _ in range(31):
        mid = lo + (hi - lo + 1) // 2  # upper mid, so lo = mid makes progress
        enough = (bits >= mid).sum() >= k
        lo = torch.where(enough, mid, lo)
        hi = torch.where(enough, hi, mid - 1)
    return lo.view(torch.float32)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor):
    """(B, C, H, W) logits + (B, H, W) int labels -> per-pixel CE (0 where
    ignored), valid mask."""
    labels = labels.long()
    ce = F.cross_entropy(logits.float(), labels, ignore_index=IGNORE_LABEL, reduction="none")
    return ce, labels != IGNORE_LABEL


def ohem_ce_loss(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                 n_min: int = 16, thresh_is_prob: bool = True) -> torch.Tensor:
    """Online hard example mining CE: the mean of the per-pixel losses above
    -log(thresh) if more than n_min exceed it, else the mean of the top
    n_min.

    The pivot is the exact (n_min + 1)-th largest loss (the value a sort
    would give, found by `_kth_largest_nonneg`), detached. The top-n_min sum
    is built from it, sum(x > pivot) + pivot * (n_min - #(x > pivot)), which is exact with
    ties, so the gradient is the JAX package's: 1 / n_min on every loss
    above the pivot."""
    # -log(thresh) in f32 on the host: a tensor made from it on the card
    # would wait for the device.
    t = float(-np.log(np.float32(thresh))) if thresh_is_prob else float(thresh)
    ce, _ = _per_pixel_ce(logits, labels)
    flat = ce.reshape(-1)
    n_min = min(n_min, flat.numel() - 1)
    pivot = _kth_largest_nonneg(flat.detach(), n_min + 1)
    gt = flat > pivot
    n_gt = gt.sum()
    topk_mean = ((flat * gt).sum() + pivot * (n_min - n_gt)) / n_min
    mask_thresh = flat > t
    count = mask_thresh.sum().clamp_min(1)
    thresh_mean = (flat * mask_thresh).sum() / count
    return torch.where(pivot > t, thresh_mean, topk_mean)


def softmax_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float = 2.0) -> torch.Tensor:
    """(1 - p)^gamma-weighted NLL, mean over valid pixels; p = exp(-CE)."""
    ce, valid = _per_pixel_ce(logits, labels)
    focal = (1.0 - torch.exp(-ce)) ** gamma * ce
    focal = torch.where(valid, focal, torch.zeros_like(focal))
    return focal.sum() / valid.sum().clamp_min(1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain mean CE over valid pixels."""
    ce, valid = _per_pixel_ce(logits, labels)
    return ce.sum() / valid.sum().clamp_min(1)
