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
  NCHW bf16 on the tensor cores (wgmma with the activated pixels from
  registers, f32 accumulators) that applies the prologue on the way into
  shared memory, zeroes the halo after the activation, and adds bias in the
  epilogue. The batch is folded into the pixel tiles; the weights are
  packed once per weight tensor (`packed_weight`) into the tiles the kernel
  fetches with one bulk copy each; where the grid would not fill the card,
  Cin is split (`cin_splits`) and a second pass adds the splits' f32 sums
  in a fixed order. Bound: tensor-core operations at most SD shapes, weight
  bytes at 8 x 8.

`fused_conv_wanted(shape)` is the port's rule for where a ResnetBlock fuses:
4 <= H, W <= 64 (the shape part of the JAX `_plan`) and Cin % 8 == 0 (the
kernel's 16-byte rows of weights). The JAX plan's VMEM budget is the TPU's
and is dropped, so the UNet's 64 x 64 x 320 stage fuses here. Under a
spatial split it reads the whole map's shape, as GSPMD's `_plan` does, so
the same convs fuse split and whole.

Under a spatial split (`ops.split`; `gn_silu_conv3x3`): `gn_affine_coeffs`
folds the ranks' per-(n, c) (mean, M2) by Chan's formula
(`combine_moments`), so every rank gets the same (A, B) bits, and its
backward sums the ranks' gradients of the folded moments before they flow
into each rank's rows (without that sum the latent's gradient would carry
one rank's share of the moment path). K7 takes the rank's rows with one
raw row of each neighbour (`halo_rows`), (N, Cin, h + 2, W), and a flag
for each edge: a halo row is activated with the same (A, B) like any
other row when its flag is set, and stays zero at the image's true edges
(the conv pads after the activation). Its backward takes the transposed
conv of the cotangent with no row padding (h + 2 rows), zeroes the rows
that are not real, and `halo_rows` returns the halo's part to its owner.

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
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .split import all_reduce_sum, combine_moments, current, halo_rows

MIN_HW, MAX_HW = 4, 64  # kMinHW, kMaxHW of csrc/affine_silu_conv3x3.cu
TILE_PIXELS, CHUNK_CIN = 128, 64  # BM, KC of the kernel
TILE_COUTS = (128, 160)  # the kernel's BN instantiations
H100_SMS = 132  # one block of K7 an SM
# `cin_splits` counts time in steps (one tap of one chunk of one block): a
# block's prologue and epilogue cost about 4, a split's partial sums and the
# pass that adds them about 12 (chosen against a sweep of forced splits over
# the SD-1.5 shapes with scripts/torch_bench_fused_conv.py on an H100).
BLOCK_OVERHEAD_STEPS, SPLIT_OVERHEAD_STEPS = 4, 12
# Bits of K7's `halo` argument: x holds a halo row above and below each
# image's rows; the row above / below is an image row (else the image's edge).
HALO_ROWS, TOP_REAL, BOTTOM_REAL = 1, 2, 4


class _FoldMoments(torch.autograd.Function):
    """The whole map's per-(n, c) (mean, M2) from each rank's over `count`
    values (`combine_moments`). Backward: the ranks' gradients of the
    folded moments summed (f32), then each rank's share by the chain rule:
    mean = sum_r mean_r / R, M2 = sum_r (M2_r + count (mean_r - mean)^2)."""

    @staticmethod
    def forward(ctx, mean, m2, count, split):
        mean_t, m2_t = combine_moments(mean, m2, count, split)
        ctx.save_for_backward(mean, mean_t)
        ctx.count, ctx.split = count, split
        return mean_t, m2_t

    @staticmethod
    def backward(ctx, dmean_t, dm2_t):
        mean, mean_t = ctx.saved_tensors
        split = ctx.split
        d = all_reduce_sum(torch.stack([dmean_t.float(), dm2_t.float()]), split.group)
        dmean = d[0] / split.size + d[1] * (2.0 * ctx.count) * (mean - mean_t)
        return dmean, d[1], None, None


def gn_affine_coeffs(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-6,
                     shift: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) f32 (A, B), each (N, C), with x * A + B equal to
    GroupNorm(x + shift) * scale + bias; `shift` is (N, C) and folds into the
    group moments by the law of total variance, so x + shift is never made:
    var_g = mean_c(var_c + (mean_c + t_c - mu_g)^2). The per-(n, c) moments
    come from `torch.var_mean` (Welford's form, which, like the JAX
    function's two-pass form, does not cancel for large-mean activations).
    Under a spatial split x is the rank's rows and the moments are folded
    over the ranks (`_FoldMoments`)."""
    n, c = x.shape[:2]
    cg = c // num_groups
    var_bc, mean_bc = torch.var_mean(x.float(), dim=(2, 3), correction=0)  # (N, C)
    split = current()
    if split is not None:
        count = x.shape[2] * x.shape[3]
        mean_bc, m2 = _FoldMoments.apply(mean_bc, var_bc * count, count, split)
        var_bc = m2 / (count * split.size)
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


def edges_zeroed(t: torch.Tensor, halo: Optional[Tuple[bool, bool]]) -> torch.Tensor:
    """t (N, C, h + 2, W) with its first / last row zeroed where `halo` says
    it is not an image row; t as it is for a whole map (`halo` None)."""
    if halo is None or all(halo):
        return t
    t = t.clone()
    if not halo[0]:
        t[:, :, 0] = 0
    if not halo[1]:
        t[:, :, -1] = 0
    return t


def conv_padding(halo) -> Tuple[int, int]:
    """The conv's (rows, columns) padding: none on the rows of a halo form."""
    return (1, 1) if halo is None else (0, 1)


def affine_silu_conv3x3_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                                  w: torch.Tensor, bias: torch.Tensor,
                                  halo: Optional[Tuple[bool, bool]] = None) -> torch.Tensor:
    """JAX `_jnp_fwd`: f32 prologue and SiLU, cast to x's dtype, conv in x's
    dtype (`F.conv2d`), then + bias. The plain version of K7. With `halo`
    (top_real, bottom_real), x holds h + 2 rows: the activation of every
    row, the edge rows zeroed where not real, then a conv padded on W only."""
    act = edges_zeroed(F.silu(_prologue(x, a, b)).to(x.dtype), halo)
    y = F.conv2d(act, w.to(x.dtype), padding=conv_padding(halo))
    return y + bias.to(y.dtype)[None, :, None, None]


# ---------------------------------------------------------------------------
# Packed weights
# ---------------------------------------------------------------------------


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> (9, chunks, Cout, CHUNK_CIN): per tap and
    chunk of CHUNK_CIN input channels (Cin zero-padded to whole chunks) the
    rows of all output channels, each row as K7 holds it in shared memory:
    its eight 16-byte pieces (8 channels each) in the 128-byte swizzle, piece
    p of row co at place p ^ (co % 8). A tile of consecutive output channels
    is then one contiguous block that K7 fetches with one bulk copy."""
    cout, cin = w.shape[:2]
    chunks = -(-cin // CHUNK_CIN)
    packed = F.pad(w.detach().permute(2, 3, 0, 1).reshape(9, cout, cin),
                   (0, chunks * CHUNK_CIN - cin))
    pieces = packed.reshape(9, cout, chunks, 8, CHUNK_CIN // 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(cout, device=w.device)
    place = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)[:, None]  # an involution
    return pieces[:, :, rows[:, None], place].reshape(9, chunks, cout, CHUNK_CIN).contiguous()


# (data_ptr, shape, device) -> (weak reference to the weight, its version, packed copy)
_PACKED: Dict[tuple, tuple] = {}


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """`pack_weight(w)`, cached per weight tensor: the guided edit's weights
    are frozen, so each is packed once. An entry serves the same tensor
    object at the same address and `_version` only: an in-place update (an
    optimizer step, `load_state_dict`) or another tensor at that address
    packs anew, and an entry goes when its tensor does. A write through
    `w.data` does not move `_version` and is not seen."""
    key = (w.data_ptr(), tuple(w.shape), w.device)
    entry = _PACKED.get(key)
    if entry is not None and entry[0]() is w and entry[1] == w._version:
        packed_weight.hits += 1
        return entry[2]

    def drop(ref, key=key):
        if key in _PACKED and _PACKED[key][0] is ref:
            del _PACKED[key]

    packed = pack_weight(w)
    _PACKED[key] = (weakref.ref(w, drop), w._version, packed)
    packed_weight.misses += 1
    return packed


packed_weight.hits = packed_weight.misses = 0


def packed_weight_bytes() -> int:
    """Bytes the cache of packed weights holds."""
    return sum(p.numel() * p.element_size() for _, _, p in _PACKED.values())


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
# device, x, a, b, packed w, bias, bias_f32, y, partial, scratch_floats, splits, BN, N, Cin,
# CinPad, Cout, H, W, halo, stream
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def tile_cout(cout: int) -> int:
    """K7's cout tile BN: the wider one where it pads Cout no more."""
    narrow, wide = TILE_COUTS
    return wide if -(-cout // wide) * wide <= -(-cout // narrow) * narrow else narrow


def cin_splits(n: int, cin: int, cout: int, h: int, w: int, sms: int = H100_SMS) -> int:
    """How many ways K7 splits Cin's chunks. The batch is folded into the
    pixel tiles, so a launch has ceil(N H W / BM) * ceil(Cout / BN) tiles,
    each split `s` ways into blocks of ceil(chunks / s) chunks of nine
    steps; blocks run in waves of `sms`. Takes the `s` of the least waves *
    (steps + BLOCK_OVERHEAD_STEPS) (+ SPLIT_OVERHEAD_STEPS where s > 1), the
    smallest such, with no empty split."""
    tiles = -(-n * h * w // TILE_PIXELS) * -(-cout // tile_cout(cout))
    chunks = -(-cin // CHUNK_CIN)
    best, best_cost = 1, None
    for s in range(1, chunks + 1):
        per_split = -(-chunks // s)
        if -(-chunks // per_split) != s:  # would leave an empty split
            continue
        cost = (-(-tiles * s // sms) * (9 * per_split + BLOCK_OVERHEAD_STEPS)
                + (SPLIT_OVERHEAD_STEPS if s > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def shape_refused(x_shape: Sequence[int], w_shape: Sequence[int],
                  halo: bool = False) -> Optional[str]:
    """Why K7 does not take an input and a weight of these shapes, or None.
    With `halo`, x holds a rank's h rows and their halo, h + 2, and h may
    be as small as 1."""
    if len(x_shape) != 4 or len(w_shape) != 4 or tuple(w_shape[1:]) != (x_shape[1], 3, 3):
        return (f"x {tuple(x_shape)} and w {tuple(w_shape)} are not (N, Cin, H, W) and "
                f"(Cout, Cin, 3, 3)")
    n, cin, h, wd = x_shape
    h -= 2 if halo else 0
    if not ((1 if halo else MIN_HW) <= h <= MAX_HW and MIN_HW <= wd <= MAX_HW and cin % 8 == 0):
        return (f"takes {'1' if halo else MIN_HW} <= H <= {MAX_HW}, {MIN_HW} <= W <= {MAX_HW} "
                f"and Cin % 8 == 0, got H={h}{' (and 2 halo rows)' if halo else ''}, W={wd}, "
                f"Cin={cin}")
    if not 0 < n <= 65535 or n * max(cin, w_shape[0]) * (h + 2) * wd >= 2 ** 31:
        return f"x {tuple(x_shape)} and w {tuple(w_shape)} are out of range"
    return None


def affine_silu_conv3x3_kernel(x, a, b, w, bias, halo=None) -> torch.Tensor:
    """K7. y (N, Cout, H, W) bf16; with `halo` (top_real, bottom_real) x
    holds H + 2 rows (`affine_silu_conv3x3_reference`'s halo form)."""
    name = "affine_silu_conv3x3"
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: takes bfloat16 x and w, got {x.dtype} and {w.dtype}")
    reason = shape_refused(x.shape, w.shape, halo is not None)
    if reason:
        raise ValueError(f"{name}: {reason}")
    n, cin, h, wd = x.shape
    flags = 0
    if halo is not None:
        h -= 2
        flags = HALO_ROWS | (TOP_REAL if halo[0] else 0) | (BOTTOM_REAL if halo[1] else 0)
    cout = w.shape[0]
    for arg, t, shape, dtypes in (("x", x, x.shape, (torch.bfloat16,)),
                                  ("w", w, w.shape, (torch.bfloat16,)),
                                  ("a", a, (n, cin), (torch.float32,)),
                                  ("b", b, (n, cin), (torch.float32,)),
                                  ("bias", bias, (cout,), (torch.bfloat16, torch.float32))):
        if (t.device != x.device or tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
                or not t.is_contiguous() or (arg != "bias" and t.data_ptr() % 16)):
            raise ValueError(f"{name}: {arg} must be contiguous {tuple(shape)} of {dtypes} on "
                             f"{x.device}, 16-byte aligned, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    packed = packed_weight(w)
    y = torch.empty((n, cout, h, wd), dtype=torch.bfloat16, device=x.device)
    splits = cin_splits(n, cin, cout, h, wd)
    partial = (torch.empty(splits * y.numel(), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    _build.launch(name, _ARGTYPES, x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  packed.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.float32),
                  y.data_ptr(), None if partial is None else partial.data_ptr(),
                  0 if partial is None else partial.numel(), splits, tile_cout(cout), n, cin,
                  packed.shape[1] * CHUNK_CIN, cout, h, wd, flags)
    affine_silu_conv3x3_kernel.launches += 1
    return y


affine_silu_conv3x3_kernel.launches = 0
affine_silu_conv3x3_kernel.kernel_name = "affine_silu_conv3x3"
KERNEL_WRAPPERS = (affine_silu_conv3x3_kernel,)


def _weight_grad(act: torch.Tensor, w: torch.Tensor, g: torch.Tensor, padding) -> torch.Tensor:
    """dw of conv3x3(act, w) with this padding, for the cotangent g."""
    return torch.nn.grad.conv2d_weight(act, w.shape, g, padding=padding).to(w.dtype)


class _AffineSiluConv3x3(torch.autograd.Function):
    """K7 (CUDA) or the plain version (CPU) forward; JAX's `_fused_vjp_bwd`
    backward in torch ops. Saves x, A, B and w."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, halo):
        if x.is_cuda:
            y = affine_silu_conv3x3_kernel(x, a, b, w, bias, halo)
        elif x.device.type == "cpu":
            y = affine_silu_conv3x3_reference(x, a, b, w, bias, halo)
        else:
            raise ValueError(f"affine_silu_conv3x3: no kernel for device {x.device}")
        ctx.save_for_backward(x, a, b, w)
        ctx.bias_dtype, ctx.halo = bias.dtype, halo
        return y

    @staticmethod
    def backward(ctx, g):
        x, a, b, w = ctx.saved_tensors
        halo = ctx.halo
        need_x, need_a, need_b, need_w, need_bias = ctx.needs_input_grad[:5]
        g = g.contiguous()
        pre = _prologue(x, a, b)
        dx = da = db = dw = dbias = None
        if need_x or need_a or need_b:
            # The transposed conv of the cotangent, stride 1: x's rows (with
            # a halo form's edge rows, zero where they are not image rows).
            dact = F.conv_transpose2d(g, w.to(g.dtype), padding=conv_padding(halo))
            dact = edges_zeroed(dact, halo)
            dpre = torch.ops.aten.silu_backward(dact.float(), pre)
            if need_x:
                dx = (dpre * a[:, :, None, None]).to(x.dtype)
            if need_a:
                da = (dpre * x.float()).sum((2, 3))
            if need_b:
                db = dpre.sum((2, 3))
        if need_w:
            act = edges_zeroed(F.silu(pre).to(x.dtype), halo)
            dw = _weight_grad(act, w, g, conv_padding(halo))
        if need_bias:
            dbias = g.float().sum((0, 2, 3)).to(ctx.bias_dtype)
        return dx, da, db, dw, dbias, None


def affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor,
                        halo: Optional[Tuple[bool, bool]] = None) -> torch.Tensor:
    """conv3x3(silu(x * A + B), w) + bias, NCHW; A and B (N, Cin) f32, w
    (Cout, Cin, 3, 3). With `halo` (top_real, bottom_real), x is a rank's
    h rows with a neighbour's row above and below, (N, Cin, h + 2, W), and y
    (N, Cout, h, W); an edge row that is not real stands for the image's
    zero padding. CUDA tensors run K7 (or raise), CPU tensors the plain
    version; differentiable in all five tensors."""
    halo = None if halo is None else (bool(halo[0]), bool(halo[1]))
    return _AffineSiluConv3x3.apply(x.contiguous(), a.contiguous(), b.contiguous(),
                                    w.contiguous(), bias.contiguous(), halo)


def gn_silu_conv3x3(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
                    eps: float, w: torch.Tensor, conv_bias: torch.Tensor,
                    shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(silu(GroupNorm(x + shift) * scale + bias), w) + conv_bias
    through K7: (A, B) by `gn_affine_coeffs`, then `affine_silu_conv3x3`.
    Under a spatial split x is the rank's rows: the moments fold over the
    ranks and K7 takes the neighbours' rows, real but at the image's
    edges."""
    a, b = gn_affine_coeffs(x, scale, bias, num_groups, eps, shift)
    split = current()
    if split is None:
        return affine_silu_conv3x3(x, a, b, w, conv_bias)
    return affine_silu_conv3x3(halo_rows(x, split), a, b, w, conv_bias,
                               (split.index > 0, split.index < split.size - 1))
