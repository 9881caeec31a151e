"""Attention: the plain torch version and the hand-written CUDA flash kernels.

Layout at the public function: (B, S, H, D), as in the JAX package.

Kernels (`csrc/`, built by `ops._build`, bf16 in, f32 accumulation):

* `flash_attn_fwd` (K1) replaces `_resident_kernel` and `_streaming_kernel`
  (diffusion_image_editing_tpu/ops/attention.py). On the H100 both compute
  one function, so one kernel serves every shape of the SD path: UNet
  self-attention (4096/1024/256/64 tokens, head dim 40/80/160), the 77-token
  cross-attention (ragged K, masked in the kernel) and the VAE's 4096-token
  single head of dim 512. Bound: tensor-core operations (4*S_q*S_k*D per
  head, 100+ operations per byte) at the 4096-token shapes, bytes at the
  short ones; at head dim 40 the S_q*S_k exponentials. Design: a block of
  query rows walks K/V tiles, streamed into shared memory, with an online
  f32 softmax; the products run on the tensor cores and S, P and O stay in
  registers. Up to a padded head dim of 160 a warp owns 16 whole rows
  (mma.sync m16n8k16, cp.async); the padded widths of
  `FWD_ROWS128_HEAD_DIMS` (the SD UNet's 40 -> 48 and 80, the LDM UNet's
  32) take a design cut for short heads: 128-row blocks over a 3-slot K/V
  ring, Q held in registers, one FFMA and one `ex2` a logit, the row sum
  taken by the PV product through a ones column of V, and the keys split
  over a cluster of two blocks where the grid is short and the keys many.
  The padded widths of `FWD_WG_HEAD_DIMS` (the SD UNet's 160) take a
  warpgroup a block: 64 query rows, S and P V by wgmma from shared memory,
  Q, K, V and O through TMA, the keys split over a cluster of two where
  the grid is short. The wide slices of
  `FWD_WIDE_SLICE_DIMS` (the VAE's 512) take warpgroups: two of them split
  the 512 columns of a 64-row block, sum their halves of Q K^T (wgmma)
  through shared memory and each run P V (wgmma) on its half of V; K/V
  tiles arrive by TMA, and the keys are split over a cluster of two
  blocks that combine their partial sums at the end.
* `flash_attn_bwd_dq` (K2) replaces `_bwd_dq_kernel` and
  `flash_attn_bwd_dkv` (K3) replaces `_bwd_dkv_kernel`. Bound: operations
  (6 and 8 * S_q*S_k*D per head). Design: the recompute backward on the
  forward's tiling. P is rebuilt from the forward's log-sum-exp, so nothing
  of size S^2 is stored; P and dS feed the next products from registers;
  each block owns its dQ (K2) or dK/dV (K3) rows, so the sums need no
  atomics and are deterministic. K2's wide slices of
  `BWD_DQ_WIDE_SLICE_DIMS` (the VAE's 512) take warpgroups: a block owns
  64 query rows and two warpgroups 256 of the 512 columns of dQ each (Q
  held in registers); their shares of S and dP (wgmma) are added through
  shared memory once a 32-key tile, dO/K/V arrive by TMA, and the keys are
  split over a cluster of two blocks that add their dQ partials at the
  end. K3's wide slices of `BWD_DKV_WIDE_SLICE_DIMS` take warpgroups too:
  a cluster of two blocks owns 64 keys, one block dV and the other dK of
  all 512 columns; the first computes S^T (wgmma) and sends it to the
  second, which computes dP^T, once a 32-query tile, and Q/dO tiles
  arrive by TMA.

The plain versions are `attention_reference` (K1; its torch autograd is the
whole backward) and `attention_bwd_dq_reference` / `attention_bwd_dkv_reference`
(K2 / K3, from the same lse and delta the kernels take). `attention()`
launches the kernels for CUDA tensors and raises when it cannot; it takes
`attention_reference` for CPU tensors only. Each kernel wrapper counts its
launches in the tracer's counter `ops.launches.<kernel>` (read by
`ops.launch_counts()`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logging import COUNTERS, span
from . import _build

_NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact softmax attention: f32 logits and softmax, probabilities cast to
    v's dtype for the second product. (B, S, H, D) in and out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = logits.shape[-2:]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def _probs_and_dlogits(q, k, v, dout, lse, delta, scale):
    """P = exp(Q K^T * scale - lse) and dS = P * (dO V^T - delta), f32,
    (B, H, S_q, S_k); lse and delta are (B*H, S_q)."""
    b, s_q, h, _ = q.shape
    lse = lse.float().reshape(b, h, s_q, 1)
    delta = delta.float().reshape(b, h, s_q, 1)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale - lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta)


def attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """The plain version of K2: dQ = dS K * scale, recomputing P from the
    forward's log-sum-exp; f32 inside, q's dtype out."""
    _, ds = _probs_and_dlogits(q, k, v, dout, lse, delta, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale: float):
    """The plain version of K3: (dK, dV) = (dS^T Q * scale, P^T dO)."""
    p, ds = _probs_and_dlogits(q, k, v, dout, lse, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # device, q, k, v, o, lse, B, H, Sq, Sk, D, scale, stream
    "flash_attn_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # device, q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, scale, stream
    "flash_attn_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # device, q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, scale, stream
    "flash_attn_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}
# The padded head dims the kernels are built for (FA_NARROW_DIMS and
# FA_WIDE_SLICES in csrc/flash_attn_common.cuh): a head dim is zero-padded
# to a multiple of 16 up to 160, or above that to a multiple of 64 cut in
# four slices.
NARROW_HEAD_DIMS = (16, 32, 48, 64, 80, 160)
WIDE_SLICE_DIMS = (128,)
# The padded narrow widths whose forward takes the 128-row design
# (FA_FWD_ROWS128_DIMS in csrc/flash_attn_fwd.cu), where the bench script
# read it faster.
FWD_ROWS128_HEAD_DIMS = (32, 48, 80)
# The padded narrow widths whose forward takes the warpgroup design
# (FA_FWD_WG_DIMS in csrc/flash_attn_fwd.cu): the SD UNet's 160, where the
# bench script read it faster at every shape of the path. Both tables key on
# the width alone: within a design, the launcher picks the key split and the
# key tile from the grid and the key count.
FWD_WG_HEAD_DIMS = (160,)
# The wide slices (a quarter of the padded head dim) whose forward takes the
# warpgroup design (FA_FWD_WIDE_SLICES in csrc/flash_attn_fwd.cu): every
# wide slice built, since the design replaced the four-warp slices there.
FWD_WIDE_SLICE_DIMS = (128,)
# The wide slices whose dK/dV backward takes the warpgroup design
# (FA_BWD_DKV_WIDE_SLICES in csrc/flash_attn_bwd_dkv.cu): every wide slice
# built, since it replaced the four-warp slices there.
BWD_DKV_WIDE_SLICE_DIMS = (128,)
# The wide slices whose dQ backward takes the warpgroup design
# (FA_BWD_DQ_WIDE_SLICES in csrc/flash_attn_bwd_dq.cu): every wide slice
# built, since it replaced the four-warp slices there.
BWD_DQ_WIDE_SLICE_DIMS = (128,)


# Every attention kernel launches a grid of (blocks of rows, B * H): CUDA
# allows at most 65535 blocks along y.
GRID_Y_MAX = 65535


def kernel_takes_head_dim(d: int) -> bool:
    if d < 8 or d % 8:
        return False
    return -(-d // 16) * 16 in NARROW_HEAD_DIMS or -(-d // 64) * 16 in WIDE_SLICE_DIMS


def _check_bshd(name: str, **tensors: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate (B, S, H, D) bf16 CUDA operands of one kernel call and return
    (B, H, S_q, S_k, D). q and dout share S_q; k and v share S_k."""
    ref = tensors["q"]
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {ref.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be (B, S, H, D), got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    b, s_q, h, d = ref.shape
    s_k = tensors["k"].shape[1]
    for arg, t in tensors.items():
        s = s_k if arg in ("k", "v") else s_q
        if tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {(b, s, h, d)}")
    if not kernel_takes_head_dim(d):
        raise ValueError(
            f"{name}: head dim {d} is not built; a multiple of 8 that pads to one of "
            f"{NARROW_HEAD_DIMS}, or to four slices of one of {WIDE_SLICE_DIMS}")
    if b * h > GRID_Y_MAX:
        raise ValueError(f"{name}: B * H = {b * h} heads exceed the {GRID_Y_MAX} blocks of the "
                         "launch grid's y dimension, which takes one a head")
    return b, h, s_q, s_k, d


def _check_stats(name: str, q: torch.Tensor, b: int, h: int, s_q: int,
                 **stats: torch.Tensor) -> None:
    for arg, t in stats.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, s_q)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name}: {arg} must be contiguous float32 on {q.device} of shape "
                f"{(b * h, s_q)}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(name, _ARGTYPES[name], device, *args)


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1. Returns (O (B, S_q, H, D) bf16, lse (B*H, S_q) f32 or None)."""
    b, h, s_q, s_k, d = _check_bshd("flash_attn_fwd", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device) if with_lse else None
    _launch("flash_attn_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None,
            b, h, s_q, s_k, d, float(scale))
    COUNTERS["ops.launches.flash_attn_fwd"] += 1
    return out, lse


def flash_attn_bwd_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """K2. dQ (B, S_q, H, D) bf16 from the forward's lse and delta = rowsum(dO*O)."""
    b, h, s_q, s_k, d = _check_bshd("flash_attn_bwd_dq", q=q, k=k, v=v, dout=dout)
    _check_stats("flash_attn_bwd_dq", q, b, h, s_q, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    _launch("flash_attn_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, s_q, s_k, d, float(scale))
    COUNTERS["ops.launches.flash_attn_bwd_dq"] += 1
    return dq


def flash_attn_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """K3. (dK, dV), each (B, S_k, H, D) bf16."""
    b, h, s_q, s_k, d = _check_bshd("flash_attn_bwd_dkv", q=q, k=k, v=v, dout=dout)
    _check_stats("flash_attn_bwd_dkv", q, b, h, s_q, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attn_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s_q, s_k, d, float(scale))
    COUNTERS["ops.launches.flash_attn_bwd_dkv"] += 1
    return dk, dv


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, S, H, D) -> (B*H, S): the backward's
    row term, one elementwise pass outside the kernels as in the JAX package."""
    b, s, h, _ = out.shape
    delta = (dout.float() * out.float()).sum(-1)  # (B, S, H)
    return delta.transpose(1, 2).reshape(b * h, s).contiguous()


class _FlashAttention(torch.autograd.Function):
    """K1 with log-sum-exp forward; K2 + K3 backward. Saves q, k, v, O and
    lse, nothing of size S^2."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attn_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with span("ops.attention.bwd", q, k):
            dout = dout.contiguous()
            delta = attention_delta(dout, out)
            dq = flash_attn_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
            dk, dv = flash_attn_bwd_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention, (B, S, H, D). CUDA tensors run the flash kernels
    (forward, and backward when a gradient is needed) or raise; CPU tensors
    run `attention_reference`, as do causal masks (only CLIP uses them)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with span("ops.attention", q, k):
        if causal or q.device.type == "cpu":
            return attention_reference(q, k, v, scale, causal=causal)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashAttention.apply(q, k, v, float(scale))
        out, _ = flash_attn_fwd(q, k, v, float(scale), with_lse=False)
        return out
