"""Ops: attention, GroupNorm, the fused GroupNorm+SiLU -> conv3x3 and
activated batch norm, each with hand-written CUDA kernels and a plain torch
version; plain convs go to cuDNN; `resize` and `morphology` (segmentation
masks) are torch ops.

Each kernel wrapper counts its launches in the tracer's counter
`ops.launches.<kernel>`; `launch_counts()` / `reset_launch_counts()` read
and zero them, by kernel name."""

from ..utils.logging import CounterView
from . import abn, attention, fused_conv, groupnorm  # noqa: F401
from ._build import KERNELS

LAUNCHES = CounterView("ops.launches.", KERNELS)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.reset()
