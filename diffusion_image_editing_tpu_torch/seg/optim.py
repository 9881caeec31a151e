"""Optimizer for BiSeNet training: SGD with momentum, exponential warmup
then poly decay, and four parameter groups (weight decay or not, times
learning-rate multiplier 10 or not): the port of the JAX package's
`seg/optim.py` (optax there).

The update follows optax's order, which `torch.optim.SGD` shares: decay
added to the gradient, then momentum without dampening (the first step's
buffer is the gradient), then the step lr * buffer. The learning rate is
`schedule(count)`, count the number of updates before this one; the
trainer writes it into every group before each step
(`set_learning_rate`).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn as nn

LR_MUL_MODULES = ("ffm", "conv_out", "conv_out16", "conv_out32")
GROUPS = ("wd", "nowd", "wd_mul", "nowd_mul")


def warmup_poly_schedule(lr0: float = 1e-2, warmup_steps: int = 1000,
                         warmup_start_lr: float = 1e-5, max_iter: int = 80000,
                         power: float = 0.9) -> Callable[[int], float]:
    """lr(it) = warmup_start * (lr0 / warmup_start)^(it / warmup) during
    warmup, then lr0 * (1 - it / max_iter)^power, in f32 as in JAX."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            ratio = f32(lr0 / warmup_start_lr) ** (s / f32(warmup_steps))
            return float(f32(warmup_start_lr) * ratio)
        factor = np.clip(f32(1.0) - s / f32(max_iter), f32(0.0), f32(1.0)) ** f32(power)
        return float(f32(lr0) * factor)

    return schedule


def param_group_label(name: str, param: torch.Tensor) -> str:
    """wd / nowd / wd_mul / nowd_mul of one parameter, by its path: weight
    decay iff the tensor has ndim > 1 (conv kernels), 10x lr iff the path
    passes through the fusion module or an output head."""
    lr_mul = any(part in LR_MUL_MODULES for part in name.split("."))
    wd = param.ndim > 1
    return ("wd" if wd else "nowd") + ("_mul" if lr_mul else "")


def param_groups(model: nn.Module) -> Dict[str, List[str]]:
    """Parameter names by group label."""
    groups: Dict[str, List[str]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups[param_group_label(name, p)].append(name)
    return groups


def make_optimizer(model: nn.Module, momentum: float = 0.9, weight_decay: float = 5e-4,
                   lr_mul: float = 10.0) -> torch.optim.SGD:
    """SGD over the model's four parameter groups (empty ones left out);
    each group carries its `lr_mul`. The learning rate is set per step by
    `set_learning_rate`."""
    params = dict(model.named_parameters())
    groups = []
    for label, names in param_groups(model).items():
        if names:
            groups.append({"params": [params[n] for n in names], "label": label,
                           "weight_decay": weight_decay if label.startswith("wd") else 0.0,
                           "lr_mul": lr_mul if label.endswith("_mul") else 1.0})
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum, dampening=0.0, nesterov=False)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mul"]
