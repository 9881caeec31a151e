"""GroupNorm(+shift) + SiLU -> 3x3 conv, fused: the plain torch version, the
hand-written CUDA kernel and its autograd.

    y = conv3x3(silu(x * A + B), w) + bias

with (A, B) per (batch, input channel). `gn_affine_coeffs` makes (A, B)
encode GroupNorm(x + shift) * scale + bias exactly, where `shift` is a
per-(batch, channel) constant such as the ResnetBlock's time-embedding
projection:

    gn(x + t) * gamma + beta = x * (gamma * rstd) + ((t - mu) * gamma * rstd + beta)

Kernel (`csrc/affine_silu_conv3x3.cu`, built by `ops._build`):

* `affine_silu_conv3x3` (K7) replaces `_fused_kernel`
  (diffusion_image_editing_tpu/ops/fused_conv.py): an implicit GEMM over
  NCHW bf16 on the tensor cores (mma.sync, f32 accumulators) that applies
  the prologue on the way into shared memory, zeroes the halo after the
  activation, and adds bias in the epilogue; where the grid would not fill
  the card, Cin is split (`cin_splits`) and a second pass adds the splits'
  f32 sums in a fixed order. Bound: tensor-core operations at most SD
  shapes, weight bytes at 8 x 8.

`fused_conv_wanted(shape)` is the port's rule for where a ResnetBlock fuses:
4 <= H, W <= 64 (the shape part of the JAX `_plan`) and Cin % 8 == 0 (the
kernel's 16-byte rows of weights). The JAX plan's VMEM budget is the TPU's
and is dropped, so the UNet's 64 x 64 x 320 stage fuses here.

The plain version is `affine_silu_conv3x3_reference` (JAX `_jnp_fwd`).
`affine_silu_conv3x3()` launches K7 for a CUDA tensor or raises; it takes the
plain version for a CPU tensor only. Its backward is JAX's hand-written
`_fused_vjp_bwd` in torch ops: the activation's gradient by the transposed
conv of the cotangent (cuDNN, as XLA runs it in JAX), the prologue's
gradient from the pre-activation rebuilt elementwise, and the weight
gradient only when asked for (the guidance gradient needs dx alone; this is
what XLA's dead-code elimination gives the JAX package). The gradient that
reaches x through (A, B) flows through `gn_affine_coeffs` by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

MIN_HW, MAX_HW = 4, 64  # kMinHW, kMaxHW of csrc/affine_silu_conv3x3.cu
TILE_PIXELS, TILE_COUT, CHUNK_CIN = 128, 128, 16  # BM, BN, KC of the kernel
FILL_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
MIN_SPLIT_CHUNKS = 8  # a split walks at least 8 chunks (128 input channels)


def gn_affine_coeffs(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-6,
                     shift: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) f32 (A, B), each (N, C), with x * A + B equal to
    GroupNorm(x + shift) * scale + bias; `shift` is (N, C) and folds into the
    group moments by the law of total variance, so x + shift is never made:
    var_g = mean_c(var_c + (mean_c + t_c - mu_g)^2). The per-(n, c) moments
    come from `torch.var_mean` (Welford's form, which, like the JAX
    function's two-pass form, does not cancel for large-mean activations)."""
    n, c = x.shape[:2]
    cg = c // num_groups
    var_bc, mean_bc = torch.var_mean(x.float(), dim=(2, 3), correction=0)  # (N, C)
    if shift is not None:
        mean_bc = mean_bc + shift.float()
    mean_grouped = mean_bc.reshape(n, num_groups, cg)
    mu_g = mean_grouped.mean(2)  # (N, G)
    var_g = (var_bc.reshape(n, num_groups, cg)
             + (mean_grouped - mu_g[..., None]).square()).mean(2)
    rstd = torch.rsqrt(var_g + eps)
    a = scale.float()[None] * rstd.repeat_interleave(cg, 1)
    t_bc = 0.0 if shift is None else shift.float()
    b = bias.float()[None] + (t_bc - mu_g.repeat_interleave(cg, 1)) * a
    return a, b


def fused_conv_wanted(shape: Sequence[int]) -> bool:
    """Whether a conv over an (N, Cin, H, W) input fuses its prologue."""
    _, cin, h, w = shape
    return MIN_HW <= h <= MAX_HW and MIN_HW <= w <= MAX_HW and cin % 8 == 0


def _prologue(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x * A + B in f32, (N, C, H, W)."""
    return torch.addcmul(b[:, :, None, None], x.float(), a[:, :, None, None])


def affine_silu_conv3x3_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                                  w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """JAX `_jnp_fwd`: f32 prologue and SiLU, cast to x's dtype, conv in x's
    dtype (`F.conv2d`), then + bias. The plain version of K7."""
    act = F.silu(_prologue(x, a, b)).to(x.dtype)
    y = F.conv2d(act, w.to(x.dtype), padding=1)
    return y + bias.to(y.dtype)[None, :, None, None]


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
# device, x, a, b, w, bias, bias_f32, y, partial, scratch_floats, splits, N, Cin, Cout, H, W,
# stream
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]


def cin_splits(n: int, cin: int, cout: int, h: int, w: int) -> int:
    """How many ways K7 splits Cin: 1 where the grid of (pixel tile, cout
    tile, image) blocks fills the card (FILL_BLOCKS), else enough splits to
    fill it, each of at least MIN_SPLIT_CHUNKS chunks of Cin."""
    blocks = -(-h * w // TILE_PIXELS) * -(-cout // TILE_COUT) * n
    if blocks >= FILL_BLOCKS // 2:
        return 1
    chunks = -(-cin // CHUNK_CIN)
    return max(1, min(-(-FILL_BLOCKS // blocks), chunks // MIN_SPLIT_CHUNKS))


def shape_refused(x_shape: Sequence[int], w_shape: Sequence[int]) -> Optional[str]:
    """Why K7 does not take an input and a weight of these shapes, or None."""
    if len(x_shape) != 4 or len(w_shape) != 4 or tuple(w_shape[1:]) != (x_shape[1], 3, 3):
        return (f"x {tuple(x_shape)} and w {tuple(w_shape)} are not (N, Cin, H, W) and "
                f"(Cout, Cin, 3, 3)")
    n, cin, h, wd = x_shape
    if not fused_conv_wanted(x_shape):
        return f"takes {MIN_HW} <= H, W <= {MAX_HW} and Cin % 8 == 0, got H={h}, W={wd}, Cin={cin}"
    if not 0 < n <= 65535 or n * max(cin, w_shape[0]) * h * wd >= 2 ** 31:
        return f"x {tuple(x_shape)} and w {tuple(w_shape)} are out of range"
    return None


def affine_silu_conv3x3_kernel(x, a, b, w, bias) -> torch.Tensor:
    """K7. y (N, Cout, H, W) bf16."""
    name = "affine_silu_conv3x3"
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: takes bfloat16 x and w, got {x.dtype} and {w.dtype}")
    reason = shape_refused(x.shape, w.shape)
    if reason:
        raise ValueError(f"{name}: {reason}")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    for arg, t, shape, dtypes in (("x", x, x.shape, (torch.bfloat16,)),
                                  ("w", w, w.shape, (torch.bfloat16,)),
                                  ("a", a, (n, cin), (torch.float32,)),
                                  ("b", b, (n, cin), (torch.float32,)),
                                  ("bias", bias, (cout,), (torch.bfloat16, torch.float32))):
        if (t.device != x.device or tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
                or not t.is_contiguous() or (arg in ("x", "w") and t.data_ptr() % 16)):
            raise ValueError(f"{name}: {arg} must be contiguous {tuple(shape)} of {dtypes} on "
                             f"{x.device} (x and w 16-byte aligned), got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    y = torch.empty((n, cout, h, wd), dtype=torch.bfloat16, device=x.device)
    splits = cin_splits(n, cin, cout, h, wd)
    partial = (torch.empty(splits * y.numel(), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    _build.launch(name, _ARGTYPES, x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.float32), y.data_ptr(),
                  None if partial is None else partial.data_ptr(),
                  0 if partial is None else partial.numel(), splits, n, cin, cout, h, wd)
    affine_silu_conv3x3_kernel.launches += 1
    return y


affine_silu_conv3x3_kernel.launches = 0
affine_silu_conv3x3_kernel.kernel_name = "affine_silu_conv3x3"
KERNEL_WRAPPERS = (affine_silu_conv3x3_kernel,)


def _weight_grad(act: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of conv3x3(act, w), padding 1, for the cotangent g."""
    return torch.nn.grad.conv2d_weight(act, w.shape, g, padding=1).to(w.dtype)


class _AffineSiluConv3x3(torch.autograd.Function):
    """K7 (CUDA) or the plain version (CPU) forward; JAX's `_fused_vjp_bwd`
    backward in torch ops. Saves x, A, B and w."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        if x.is_cuda:
            y = affine_silu_conv3x3_kernel(x, a, b, w, bias)
        elif x.device.type == "cpu":
            y = affine_silu_conv3x3_reference(x, a, b, w, bias)
        else:
            raise ValueError(f"affine_silu_conv3x3: no kernel for device {x.device}")
        ctx.save_for_backward(x, a, b, w)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, a, b, w = ctx.saved_tensors
        need_x, need_a, need_b, need_w, need_bias = ctx.needs_input_grad
        g = g.contiguous()
        pre = _prologue(x, a, b)
        dx = da = db = dw = dbias = None
        if need_x or need_a or need_b:
            # The transposed conv of the cotangent: stride 1, padding 1.
            dact = F.conv_transpose2d(g, w.to(g.dtype), padding=1)
            dpre = torch.ops.aten.silu_backward(dact.float(), pre)
            if need_x:
                dx = (dpre * a[:, :, None, None]).to(x.dtype)
            if need_a:
                da = (dpre * x.float()).sum((2, 3))
            if need_b:
                db = dpre.sum((2, 3))
        if need_w:
            dw = _weight_grad(F.silu(pre).to(x.dtype), w, g)
        if need_bias:
            dbias = g.float().sum((0, 2, 3)).to(ctx.bias_dtype)
        return dx, da, db, dw, dbias


def affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(silu(x * A + B), w) + bias, NCHW; A and B (N, Cin) f32, w
    (Cout, Cin, 3, 3). CUDA tensors run K7 (or raise), CPU tensors the plain
    version; differentiable in all five."""
    return _AffineSiluConv3x3.apply(x.contiguous(), a.contiguous(), b.contiguous(),
                                    w.contiguous(), bias.contiguous())
