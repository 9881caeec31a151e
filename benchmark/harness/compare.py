"""The numbers that decide `correct`, and the judgement against limits."""

from __future__ import annotations

import math
from typing import Dict

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor, per_sample: bool = True,
            mask: torch.Tensor = None) -> float:
    """||got - want|| / ||want|| in float64: the largest over the leading
    (sample) axis, or with `per_sample=False` over the whole tensor; NaN or
    infinity wherever `got` is not finite. With `mask` (got's shape), only
    the elements where it is true count; a sample with none reads
    infinity."""
    rows = got.shape[0] if per_sample else 1
    g = got.detach().double().reshape(rows, -1)
    w = want.detach().to(g.device).double().reshape(rows, -1)
    if g.shape != w.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against {tuple(want.shape)}")
    if mask is not None:
        m = mask.to(g.device).reshape(rows, -1)
        g, w = g * m, w * m
        w_norm = w.norm(dim=1)
        return float(torch.where(w_norm > 0, (g - w).norm(dim=1) / w_norm, math.inf).max())
    err = (g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)
    return float(err.max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number passes when it is finite and
    at most its limit. Every limit must have its number."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"no reading for the limits {missing}")
    return {k: {"value": numbers[k], "limit": limits[k],
                "ok": math.isfinite(numbers[k]) and numbers[k] <= limits[k]}
            for k in sorted(limits)}


def all_ok(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["ok"] for c in checks.values())
