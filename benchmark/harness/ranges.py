"""Profiler ranges that the benchmark opens around its calls into the
program's layers, for the traced calls only:

- `bench.unet`: each call of the denoiser closure (the UNet, CFG included);
- `bench.nudge`: each call of the attribute function (a guidance nudge:
  decode, loss, and the gradient back through the decoder);
- `bench.attn` / `bench.gn`: each call of the port's public `attention` /
  `group_norm`, patched where the models look them up, with the call's
  analytic work recorded for the roofline metrics. Forward calls only: a
  backward runs later on autograd's thread, outside the call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

from torch.profiler import record_function

from .flops import attention_work, group_norm_work

UNET, NUDGE, ATTN, GN, WINDOW = ("bench.unet", "bench.nudge", "bench.attn", "bench.gn",
                                 "bench.window")


@dataclasses.dataclass
class Work:
    attn: List[tuple] = dataclasses.field(default_factory=list)  # (FLOPs, bytes) a call
    gn: List[tuple] = dataclasses.field(default_factory=list)


class RangedEps:
    """A denoiser closure whose every call runs inside `bench.unet`."""

    def __init__(self, eps_fn):
        self.eps_fn = eps_fn

    def __call__(self, x, t):
        with record_function(UNET):
            return self.eps_fn(x, t)


def wrapped_attr(attr_func, around):
    """A copy of `attr_func` (a frozen AttrFunc dataclass) whose
    `apply_batched`, the call the guided loop makes once a step, runs as
    `around(apply_batched, self, *args, **kwargs)`. The copy is of a
    subclass, which `dataclasses.replace` keeps."""
    cls = type(attr_func)

    def apply_batched(self, *args, **kwargs):
        return around(cls.apply_batched, self, *args, **kwargs)

    sub = dataclasses.dataclass(frozen=True)(
        type(cls.__name__, (cls,), {"apply_batched": apply_batched}))
    return sub(**{f.name: getattr(attr_func, f.name) for f in dataclasses.fields(attr_func)})


def _in_nudge_range(apply_batched, *args, **kwargs):
    with record_function(NUDGE):
        return apply_batched(*args, **kwargs)


def ranged_attr(attr_func):
    """A copy of `attr_func` whose every nudge runs inside `bench.nudge`."""
    return wrapped_attr(attr_func, _in_nudge_range)


@contextlib.contextmanager
def layer_ranges(work: Work):
    """Inside the block, the port's `attention` and `group_norm` as the
    models call them run inside `bench.attn` / `bench.gn`, and each call's
    work is appended to `work`."""
    from diffusion_image_editing_tpu_torch.models import layers, unet2d_cond

    attention, group_norm = layers.attention, layers.group_norm

    def ranged_attention(q, k, v, *args, **kwargs):
        work.attn.append(attention_work(tuple(q.shape), tuple(k.shape), q.element_size()))
        with record_function(ATTN):
            return attention(q, k, v, *args, **kwargs)

    def ranged_group_norm(x, *args, **kwargs):
        work.gn.append(group_norm_work(tuple(x.shape), x.element_size(), x.shape[1]))
        with record_function(GN):
            return group_norm(x, *args, **kwargs)

    saved = (layers.attention, unet2d_cond.attention, layers.group_norm)
    layers.attention = unet2d_cond.attention = ranged_attention
    layers.group_norm = ranged_group_norm
    try:
        yield work
    finally:
        layers.attention, unet2d_cond.attention, layers.group_norm = saved


@contextlib.contextmanager
def wrapped_eps(wrapper, wrap):
    """Inside the block, every denoiser closure that `wrapper.eps_fn` makes
    is replaced by `wrap(closure)`."""
    eps_fn = wrapper.eps_fn
    wrapper.eps_fn = lambda *args, **kwargs: wrap(eps_fn(*args, **kwargs))
    try:
        yield
    finally:
        del wrapper.eps_fn


def ranged_eps(wrapper):
    """Inside the block, every denoiser closure that `wrapper.eps_fn` makes
    runs its calls inside `bench.unet`."""
    return wrapped_eps(wrapper, RangedEps)
