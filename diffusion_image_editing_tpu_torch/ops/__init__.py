"""Ops: attention, GroupNorm, the fused GroupNorm+SiLU -> conv3x3 and
activated batch norm, each with hand-written CUDA kernels and a plain torch
version; plain convs go to cuDNN.

`launch_counts()` / `reset_launch_counts()` read and zero every kernel
wrapper's launch count, by kernel name."""

from . import abn, attention, fused_conv, groupnorm

KERNEL_WRAPPERS = (attention.KERNEL_WRAPPERS + groupnorm.KERNEL_WRAPPERS
                   + fused_conv.KERNEL_WRAPPERS + abn.KERNEL_WRAPPERS)


def launch_counts() -> dict:
    return {w.kernel_name: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
