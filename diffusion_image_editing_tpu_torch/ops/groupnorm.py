"""GroupNorm + affine + activation over NCHW: the plain torch version and the
hand-written CUDA kernels.

In NCHW the group (n, g) is one contiguous slab of C / G * H * W elements,
so the kernels reduce slabs; the TPU kernels' group-matrix matmul, needed
because NHWC scatters a group across the minor dimension, has no
counterpart. Kernels (`csrc/`, built by `ops._build`; bf16 in and out, f32
statistics, the two-pass variance mean((x - mean)^2) of
`group_norm_reference`, never E[x^2] - mean^2):

* `group_norm_fused` (K4) replaces `_single_block_kernel`
  (diffusion_image_editing_tpu/ops/groupnorm.py): a cluster of
  `fused_cluster_blocks` blocks a slab, one piece a block (`slab_pieces`),
  each copying its piece into shared memory by one bulk copy and taking
  its (count, mean, M2) there; the blocks' moments meet in every block
  through distributed shared memory, folded in rank order (Chan's
  formula), and each block writes its normalised, activated piece: one
  read and one write of the slab.
* `group_norm_stats` (K5) replaces `_stats_kernel`: per-(n, g) mean and rstd
  of slabs of any size, in one launch. Each slab is split over a
  thread-block cluster of `stats_cluster_blocks` blocks, so that batch 1 x
  32 groups still fills the card, one piece a block (`slab_pieces`); each
  thread folds what it streams into a running (count, mean, M2) by Chan's
  formula, and the blocks' moments meet in rank 0's shared memory, folded
  in rank order, so results are deterministic.
* `group_norm_apply` (K6) replaces `_apply_kernel`: one elementwise pass
  with per-(n, g) statistics and per-channel scale and bias.

All three are bound by bytes: K4 and K6 read and write x once, K5 reads it
once. The route is chosen by slab size: a slab of at most
`FUSED_MAX_SLAB_BYTES` (512 KiB of bf16: up to 8 pieces of at most
`FUSED_MAX_PIECE_BYTES`, 96 KiB, so that two blocks share an SM's shared
memory) takes K4, a larger one K5 then K6 (`uses_fused_kernel`). Up to
that limit K4 reads faster than K5 then K6 at every slab of the SD-1.5
path (`scripts/torch_bench_groupnorm.py --fused-limit`); the VAE's slabs
of 1 MiB and more take K5 + K6.

Plain versions: `group_norm_moments` (K5, and K4's statistics),
`group_norm_apply_reference` (K6) and `group_norm_reference` (K4, and the
whole function), `group_norm_mean_m2` (K5's (mean, M2) output).
`group_norm()` launches the kernels for a CUDA tensor, or
raises for a dtype other than bf16 or a shape they do not take; it takes the
plain version for a CPU tensor only. Its gradient is torch ops, as the JAX
package's is XLA ops (`_group_norm_bwd`): from x and the forward's saved f32
mean and rstd, the pre-activation is rebuilt elementwise for the
activation's derivative, and the normalisation's backward runs without a
second statistics pass over x. Each kernel wrapper counts its launches in
the tracer's counter `ops.launches.<kernel>`.

Under a spatial split (`ops.split`: each rank holds some rows of
every map) K4's one pass cannot span the ranks: K5 takes each rank's
(mean, M2) per slab, the ranks' moments are folded by Chan's formula in
rank order on every rank (`combine_moments`, an all-gather of N * G * 2
floats), and K6 applies the whole (mean, rstd). The backward sums its two
per-group terms over the ranks.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.logging import COUNTERS, span
from . import _build
from .split import all_reduce_sum, combine_moments, current

ACTS = (None, "silu", "relu", "gelu")  # codes 0-3 of csrc/group_norm_common.cuh
FUSED_MAX_SLAB_BYTES = 512 * 1024  # the route limit: larger slabs take K5 + K6
FUSED_MAX_PIECE_BYTES = 96 * 1024  # kFusedMaxPieceBytes of csrc/group_norm_fused.cu
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
H100_SMS = 132
# K5 and K4 split slabs over a cluster while the grid keeps within one
# block an SM and no piece falls under these bytes (`_cluster_blocks`).
STATS_MIN_PIECE_BYTES, FUSED_MIN_PIECE_BYTES = 48 * 1024, 12 * 1024


def _check_act(act: Optional[str]) -> None:
    if act not in ACTS:
        raise ValueError(f"Unknown activation {act!r}; have {ACTS}")


def _activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """JAX's `_activate`: gelu is the tanh form (jax.nn.gelu's default)."""
    if act is None:
        return x
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return torch.relu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"Unknown activation {act!r}; have {ACTS}")


def _activate_backward(dy: torch.Tensor, pre: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return torch.ops.aten.silu_backward(dy, pre)
    if act == "relu":
        return torch.where(pre > 0, dy, torch.zeros_like(dy))
    if act == "gelu":
        return torch.ops.aten.gelu_backward(dy, pre, approximate="tanh")
    raise ValueError(f"Unknown activation {act!r}; have {ACTS}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def group_norm_moments(x: torch.Tensor, num_groups: int,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, g) f32 mean and rstd = 1 / sqrt(mean((x - mean)^2) + eps), (N, G)
    each: the plain version of K5."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(-1)
    var = (xf - mean[..., None]).square().mean(-1)
    return mean, torch.rsqrt(var + eps)


def group_norm_mean_m2(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(n, g) f32 mean and M2 = sum((x - mean)^2), (N, G) each: the plain
    version of K5's (mean, M2) output."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(-1)
    return mean, (xf - mean[..., None]).square().sum(-1)


def group_norm_apply_reference(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor,
                               act: Optional[str] = "silu") -> torch.Tensor:
    """act((x - mean) * rstd * scale + bias) in f32, cast to x's dtype: the
    plain version of K6."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, mean.shape[1], -1)
    xhat = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = xhat * scale.float().reshape(shape) + bias.float().reshape(shape)
    return _activate(out, act).to(x.dtype)


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float = 1e-6,
                         act: Optional[str] = "silu") -> torch.Tensor:
    """NCHW group norm + optional activation, f32 inside, cast back to x's
    dtype (JAX `group_norm_reference`, over NHWC there): the plain version
    of K4 and of the whole function."""
    _check_act(act)
    mean, rstd = group_norm_moments(x, num_groups, eps)
    return group_norm_apply_reference(x, mean, rstd, scale, bias, act)


def group_norm_backward(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        num_groups: int, act: Optional[str],
                        needs: Sequence[bool] = (True, True, True)):
    """(dx, dscale, dbias) of `group_norm_reference` from x and its saved
    (N, G) f32 mean and rstd, in f32 torch ops; an entry whose `needs` is
    False is None."""
    n, c = x.shape[:2]
    xf = x.float()
    # The incoming gradient may be a strided view (the attention block
    # transposes the normalised map); the aten backward takes contiguous ones.
    dy = grad.float().contiguous()
    if act is not None:
        a = rstd.repeat_interleave(c // num_groups, 1) * scale.float()  # (N, C)
        b = bias.float() - mean.repeat_interleave(c // num_groups, 1) * a
        pre = torch.addcmul(b[:, :, None, None], xf, a[:, :, None, None])
        dy = _activate_backward(dy, pre, act)
    dx, dscale, dbias = torch.ops.aten.native_group_norm_backward(
        dy, xf, mean, rstd, scale.float(), n, c, math.prod(x.shape[2:]), num_groups,
        [bool(k) for k in needs])
    return (None if dx is None else dx.to(x.dtype),
            None if dscale is None else dscale.to(scale.dtype),
            None if dbias is None else dbias.to(bias.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # device, x, scale, bias, affine_f32, out, mean, rstd, N, C, HW, G, cluster, eps, act, stream
    "group_norm_fused": [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # device, x, mean, rstd (or M2), N, C, HW, G, cluster, eps, out_m2, stream
    "group_norm_stats": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # device, x, mean, rstd, scale, bias, affine_f32, out, N, C, HW, G, act, stream
    "group_norm_apply": [_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
}


def slab_bytes(shape: Sequence[int], num_groups: int) -> int:
    """Bytes of one (n, g) group of a bf16 NCHW tensor."""
    return shape[1] // num_groups * math.prod(shape[2:]) * 2


def uses_fused_kernel(shape: Sequence[int], num_groups: int) -> bool:
    """The route rule: K4 for a slab of at most FUSED_MAX_SLAB_BYTES, else K5 + K6."""
    return slab_bytes(shape, num_groups) <= FUSED_MAX_SLAB_BYTES


def slab_pieces(length: int, blocks: int, atom: int) -> List[Tuple[int, int]]:
    """(start, length) in elements of each block's piece of a slab of
    `length` elements split over `blocks` blocks in whole atoms of `atom`
    elements, as the kernels cut it: piece r spans atoms
    [r * atoms // blocks, (r + 1) * atoms // blocks)."""
    atoms = length // atom
    cuts = [r * atoms // blocks * atom for r in range(blocks)] + [length]
    return [(cuts[r], cuts[r + 1] - cuts[r]) for r in range(blocks)]


def stats_atom(shape: Sequence[int], num_groups: int) -> int:
    """K5 reads 16-byte vectors (8 elements) where the slab is a multiple
    of 8 elements, so that every slab and piece starts on a 16-byte
    boundary; single elements otherwise."""
    return 8 if shape[1] // num_groups * math.prod(shape[2:]) % 8 == 0 else 1


def fused_atom(shape: Sequence[int], num_groups: int) -> int:
    """K4 copies and applies 16-byte vectors where H * W % 8 == 0: then a
    vector lies in one channel, and every slab and piece starts on a
    16-byte boundary; single elements otherwise."""
    return 8 if math.prod(shape[2:]) % 8 == 0 else 1


def _cluster_blocks(shape: Sequence[int], num_groups: int, atom: int, min_piece: int) -> int:
    """Blocks a slab is split over: doubled from 1 while the grid would
    keep within H100_SMS blocks, each piece at least `min_piece` bytes and
    at least one atom; at most 8, the largest portable cluster."""
    slabs = shape[0] * num_groups
    nbytes = slab_bytes(shape, num_groups)
    atoms = nbytes // 2 // atom
    k = 1
    while (k < CLUSTER_SIZES[-1] and slabs * 2 * k <= H100_SMS
           and nbytes // (2 * k) >= min_piece and 2 * k <= atoms):
        k *= 2
    return k


def stats_cluster_blocks(shape: Sequence[int], num_groups: int) -> int:
    """K5's cluster size."""
    return _cluster_blocks(shape, num_groups, stats_atom(shape, num_groups),
                           STATS_MIN_PIECE_BYTES)


def fused_cluster_blocks(shape: Sequence[int], num_groups: int) -> int:
    """K4's cluster size: `_cluster_blocks`, or the least that keeps every
    piece within FUSED_MAX_PIECE_BYTES if that is more (up to 8)."""
    atom = fused_atom(shape, num_groups)
    k = _cluster_blocks(shape, num_groups, atom, FUSED_MIN_PIECE_BYTES)
    atoms = slab_bytes(shape, num_groups) // 2 // atom
    while k < CLUSTER_SIZES[-1] and -(-atoms // k) * atom * 2 > FUSED_MAX_PIECE_BYTES:
        k *= 2
    return k


def _check_x(name: str, x: torch.Tensor, num_groups: int) -> Tuple[int, int, int]:
    """Validate a kernel's bf16 NCHW input; returns (N, C, H * W)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the GroupNorm kernels take bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (N, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    n, c, h, w = x.shape
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{name}: {c} channels do not split into {num_groups} groups")
    if x.numel() >= 2 ** 31 or n * num_groups > 65535 or x.numel() == 0:
        raise ValueError(f"{name}: shape {tuple(x.shape)} is out of the kernels' range")
    return n, c, h * w


def _check_affine(name: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    """scale and bias: (C,), contiguous, on x's device, both bf16 or both f32.
    Returns 1 for f32."""
    c = x.shape[1]
    for arg, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous ({c},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if scale.dtype != bias.dtype or scale.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: scale and bias must both be bfloat16 or both float32, got "
                        f"{scale.dtype} and {bias.dtype}")
    return int(scale.dtype == torch.float32)


def _check_stats(name: str, x: torch.Tensor, num_groups: int, **stats: torch.Tensor) -> None:
    for arg, t in stats.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0], num_groups)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name}: {arg} must be contiguous float32 "
                             f"{(x.shape[0], num_groups)} on {x.device}")


def group_norm_fused(x, scale, bias, num_groups: int, eps: float, act: Optional[str]):
    """K4. Returns (out bf16 like x, mean (N, G) f32, rstd (N, G) f32)."""
    _check_act(act)
    n, c, hw = _check_x("group_norm_fused", x, num_groups)
    affine_f32 = _check_affine("group_norm_fused", x, scale, bias)
    if not uses_fused_kernel(x.shape, num_groups):
        raise ValueError(f"group_norm_fused: a slab of {slab_bytes(x.shape, num_groups)} bytes "
                         f"exceeds {FUSED_MAX_SLAB_BYTES}; use K5 + K6")
    out = torch.empty_like(x)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _build.launch("group_norm_fused", _ARGTYPES["group_norm_fused"], x.device, x.data_ptr(),
                  scale.data_ptr(), bias.data_ptr(), affine_f32, out.data_ptr(), mean.data_ptr(),
                  rstd.data_ptr(), n, c, hw, num_groups, fused_cluster_blocks(x.shape, num_groups),
                  float(eps), ACTS.index(act))
    COUNTERS["ops.launches.group_norm_fused"] += 1
    return out, mean, rstd


def group_norm_stats(x, num_groups: int, eps: float = 1e-6, m2: bool = False):
    """K5. Returns (mean, rstd), (N, G) f32 each; with `m2`, (mean, M2) with
    M2 = sum((x - mean)^2) over each slab (eps unused)."""
    n, c, hw = _check_x("group_norm_stats", x, num_groups)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    second = torch.empty_like(mean)
    _build.launch("group_norm_stats", _ARGTYPES["group_norm_stats"], x.device, x.data_ptr(),
                  mean.data_ptr(), second.data_ptr(), n, c, hw, num_groups,
                  stats_cluster_blocks(x.shape, num_groups), float(eps), int(m2))
    COUNTERS["ops.launches.group_norm_stats"] += 1
    return mean, second


def group_norm_apply(x, mean, rstd, scale, bias, act: Optional[str]):
    """K6. Returns act((x - mean) * rstd * scale + bias), bf16 like x."""
    _check_act(act)
    num_groups = mean.shape[-1] if mean.dim() == 2 else 0
    n, c, hw = _check_x("group_norm_apply", x, num_groups)
    _check_stats("group_norm_apply", x, num_groups, mean=mean, rstd=rstd)
    affine_f32 = _check_affine("group_norm_apply", x, scale, bias)
    out = torch.empty_like(x)
    _build.launch("group_norm_apply", _ARGTYPES["group_norm_apply"], x.device, x.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  affine_f32, out.data_ptr(), n, c, hw, num_groups, ACTS.index(act))
    COUNTERS["ops.launches.group_norm_apply"] += 1
    return out


def group_norm_kernels(x, scale, bias, num_groups: int, eps: float, act: Optional[str]):
    """The forward on the card: K4, or K5 then K6, by `uses_fused_kernel`.
    Returns (out, mean, rstd)."""
    if uses_fused_kernel(x.shape, num_groups):
        return group_norm_fused(x, scale, bias, num_groups, eps, act)
    mean, rstd = group_norm_stats(x, num_groups, eps)
    return group_norm_apply(x, mean, rstd, scale, bias, act), mean, rstd


def _split_moments(x, num_groups: int, eps: float, split):
    """The whole (mean, rstd) of a map whose rows are split: each rank's
    (mean, M2) by K5 (CUDA) or the plain version (CPU), folded over the
    ranks."""
    local = (group_norm_stats(x, num_groups, m2=True) if x.is_cuda
             else group_norm_mean_m2(x, num_groups))
    count = x.shape[1] // num_groups * math.prod(x.shape[2:])
    mean, m2 = combine_moments(*local, count, split)
    return mean, torch.rsqrt(m2 / (count * split.size) + eps)


def split_group_norm_backward(grad, x, scale, bias, mean, rstd, num_groups: int,
                              act: Optional[str], split, needs=(True, True, True)):
    """`group_norm_backward` of a map whose rows are split: dx needs the
    per-group sums of dy * scale and of dy * scale * xhat over every rank's
    rows (one all-reduce of N * G * 2 floats). dscale and dbias are this
    rank's share."""
    n, c = x.shape[:2]
    per = c // num_groups
    shape = (n, c) + (1,) * (x.dim() - 2)
    mean_c = mean.repeat_interleave(per, 1).reshape(shape)
    rstd_c = rstd.repeat_interleave(per, 1).reshape(shape)
    xhat = (x.float() - mean_c) * rstd_c
    dy = grad.float()
    if act is not None:
        pre = xhat * scale.float().reshape(shape[1:])[None] + bias.float().reshape(shape[1:])[None]
        dy = _activate_backward(dy.contiguous(), pre, act)
    dx = dscale = dbias = None
    if needs[0]:
        dys = dy * scale.float().reshape(shape[1:])[None]
        sums = all_reduce_sum(torch.stack([dys.reshape(n, num_groups, -1).sum(-1),
                                           (dys * xhat).reshape(n, num_groups, -1).sum(-1)]),
                              split.group)
        count = per * math.prod(x.shape[2:]) * split.size
        m1 = (sums[0] / count).repeat_interleave(per, 1).reshape(shape)
        m2 = (sums[1] / count).repeat_interleave(per, 1).reshape(shape)
        dx = (rstd_c * (dys - m1 - xhat * m2)).to(x.dtype)
    dims = (0,) + tuple(range(2, x.dim()))
    if needs[1]:
        dscale = (dy * xhat).sum(dims).to(scale.dtype)
    if needs[2]:
        dbias = dy.sum(dims).to(bias.dtype)
    return dx, dscale, dbias


class _GroupNorm(torch.autograd.Function):
    """Forward by the kernels (CUDA) or the plain version (CPU); backward
    `group_norm_backward` from x and the saved mean and rstd. Under a
    spatial split the statistics are folded over the ranks (K5, then K6)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        split = current()
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"group_norm: no kernel for device {x.device}")
        if split is not None:
            mean, rstd = _split_moments(x, num_groups, eps, split)
            out = (group_norm_apply(x, mean, rstd, scale, bias, act) if x.is_cuda
                   else group_norm_apply_reference(x, mean, rstd, scale, bias, act))
        elif x.is_cuda:
            out, mean, rstd = group_norm_kernels(x, scale, bias, num_groups, eps, act)
        else:
            mean, rstd = group_norm_moments(x, num_groups, eps)
            out = group_norm_apply_reference(x, mean, rstd, scale, bias, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.num_groups, ctx.act, ctx.split = num_groups, act, split
        return out

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if ctx.split is not None:
            grads = split_group_norm_backward(grad, x, scale, bias, mean, rstd, ctx.num_groups,
                                              ctx.act, ctx.split, ctx.needs_input_grad[:3])
        else:
            grads = group_norm_backward(grad, x, scale, bias, mean, rstd, ctx.num_groups,
                                        ctx.act, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               act: Optional[str] = "silu") -> torch.Tensor:
    """NCHW group norm + activation (silu, relu, gelu in its tanh form, or
    None), `group_norm_reference` semantics. CUDA tensors run K4 or K5 + K6
    (bf16 only; anything else raises), CPU tensors the plain version."""
    _check_act(act)
    with span("ops.group_norm", x):
        return _GroupNorm.apply(x.contiguous(), scale, bias, int(num_groups), float(eps), act)
