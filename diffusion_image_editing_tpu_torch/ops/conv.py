"""3x3 stride-1 SAME convolution, NCHW, dispatched on a conv mode: the port
of `ops/conv.py`.

- "xla" (the default; the JAX package's "auto" picks it too): `F.conv2d`
  through cuDNN.
- "shift9": 9 shifted (B*H*W, Cin) x (Cin, Cout) products accumulated in
  f32, for parity with the JAX package only (it lost end to end there).
- "int8": every conv quantized: symmetric max-abs scales, per tensor for the
  activation and per output channel for the weight (an all-zero tensor gets
  scale 1), round half to even, clip to +-127, an s8 x s8 -> s32 product
  (`torch._int_mm` over a column matrix built from 9 shifted views), then
  dequantized by sx * sw to the input's dtype. Its backward is the exact
  conv's VJP at the unquantized operands (straight-through); with
  `int8_bwd` dx is itself an int8 conv of the cotangent against the
  flipped, IO-swapped kernel (per-tensor cotangent scale, per-Cin weight
  scale) and dw stays exact.
- "int8_large": "int8" for inputs with H >= `min_h` (default 128: only the
  guidance decode's large stages at SD's 512 px), "xla" below.

The JAX package reads DIE_TPU_CONV, DIE_TPU_INT8_MIN_H and DIE_TPU_INT8_BWD
at trace time; the port takes the same three settings from `conv_mode(...)`
(a context manager) or `set_conv_mode(...)`, and reads no environment
variable. An int8 conv's backward uses the `int8_bwd` of its forward.
`CALL_COUNTS` counts the dispatches by path (the counterpart of JAX's
`TRACE_COUNTS`). The fused GroupNorm+SiLU -> conv path (`ops.fused_conv`,
K7) does not come through here, as JAX's `Conv3x3(prologue=)` bypasses
`conv3x3`.

Under a spatial split (`ops.split`) every mode takes the rank's rows with
one row of each neighbour (`halo_rows`: zeros at the image's edges, and
the halo's gradient goes back to its owner) and pads the width only. An
int8 conv's per-tensor scales, the activation's and under `int8_bwd` the
cotangent's, are the max over the ranks the tensor lies on
(`ops.split.tensor_ranks`: the split's, and the CFG pair's where it too is
split over ranks), so its s32 sums and its output are the whole conv's
bits; the cotangent's int8 conv takes the cotangent's halo rows.
"int8_large" gates on the whole map's rows (a rank's rows times the
ranks), as GSPMD's partitioned program reads the global H."""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from .split import all_reduce_max, current, halo_rows, tensor_ranks

MODES = ("xla", "shift9", "int8", "int8_large")
INT8_MIN_H_DEFAULT = 128

CALL_COUNTS = {"xla": 0, "shift9": 0, "int8": 0}
_SETTINGS = {"mode": "xla", "min_h": INT8_MIN_H_DEFAULT, "int8_bwd": False}


def set_conv_mode(mode: str = "xla", min_h: int = INT8_MIN_H_DEFAULT,
                  int8_bwd: bool = False) -> dict:
    """Sets the conv mode for every later `conv3x3`; returns the previous
    settings (keywords of this function)."""
    if mode not in MODES:
        raise ValueError(f"conv mode must be one of {'|'.join(MODES)}, got {mode!r}")
    prev = dict(_SETTINGS)
    _SETTINGS.update(mode=mode, min_h=int(min_h), int8_bwd=bool(int8_bwd))
    return prev


def conv_settings() -> dict:
    return dict(_SETTINGS)


@contextlib.contextmanager
def conv_mode(mode: str, min_h: int = INT8_MIN_H_DEFAULT, int8_bwd: bool = False):
    """`with conv_mode("int8_large", min_h=128, int8_bwd=True): ...`"""
    prev = set_conv_mode(mode, min_h, int8_bwd)
    try:
        yield
    finally:
        set_conv_mode(**prev)


def conv3x3_xla(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    return F.conv2d(x, w, bias, padding=1)


def conv3x3_shift9(x: torch.Tensor, w: torch.Tensor, rows_padded: bool = False) -> torch.Tensor:
    """9 shifted (B*H*W, Cin) x (Cin, Cout) products, f32 accumulation.
    `rows_padded`: x holds H + 2 rows, its first and last the padding."""
    b, cin, h, wd = x.shape
    h -= 2 if rows_padded else 0
    xp = F.pad(x, (1, 1) if rows_padded else (1, 1, 1, 1))
    xp = xp.permute(0, 2, 3, 1)  # (B, H+2, W+2, Cin)
    acc = None
    for dy in range(3):
        for dx in range(3):
            m = xp[:, dy:dy + h, dx:dx + wd].reshape(b * h * wd, cin)
            part = m.float() @ w[:, :, dy, dx].t().float()
            acc = part if acc is None else acc + part
    return acc.reshape(b, h, wd, -1).permute(0, 3, 1, 2).to(x.dtype)


def quantize_int8(v: torch.Tensor, dims, ranks=None) -> tuple:
    """Symmetric max-abs int8 quantization over `dims`: (q, f32 scale);
    with `ranks` (a SpatialSplit), the max is over them too."""
    a = v.float().abs().amax(dim=dims, keepdim=True)
    if ranks is not None:
        a = all_reduce_max(a, ranks.group)
    scale = torch.where(a > 0, a / 127.0, torch.ones_like(a))
    q = torch.clamp(torch.round(v.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv3x3_s32(xq: torch.Tensor, wq: torch.Tensor,
                     rows_padded: bool = False) -> torch.Tensor:
    """(B, Cin, H, W) s8 x (Cout, Cin, 3, 3) s8 -> (B, Cout, H, W) s32, SAME
    padding: `torch._int_mm` of the column matrix (B*H*W, 9*Cin) built from
    9 shifted views. Cin and Cout are padded with zeros to multiples of 8
    and the rows to more than 16 (`_int_mm`'s limits on CUDA), which is
    exact. `rows_padded`: xq holds H + 2 rows, its first and last the
    padding (a rank's rows with its halo)."""
    b, cin, h, wd = xq.shape
    h -= 2 if rows_padded else 0
    cout = wq.shape[0]
    cp, op = _up8(cin), _up8(cout)
    pad_h = (0, 0) if rows_padded else (1, 1)
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, cp - cin, 1, 1) + pad_h)  # (B, H+2, W+2, Cp)
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(b * h * wd, 9 * cp)
    m = cols.shape[0]
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 32 - m))
    wmat = F.pad(wq, (0, 0, 0, 0, 0, cp - cin, 0, op - cout))  # (Op, Cp, 3, 3)
    wmat = wmat.permute(2, 3, 1, 0).reshape(9 * cp, op).contiguous()
    y = torch._int_mm(cols, wmat)[:m, :cout]
    return y.reshape(b, h, wd, cout).permute(0, 3, 1, 2)


def _int8_conv(x: torch.Tensor, w: torch.Tensor, split=None, ranks=None) -> torch.Tensor:
    """Quantize both operands, s8 x s8 -> s32, dequantize to x.dtype. With
    a `split`, x is the rank's rows with their halo; with `ranks`, x's
    scale is the max over them."""
    xq, sx = quantize_int8(x, (0, 1, 2, 3), ranks)
    wq, sw = quantize_int8(w, (1, 2, 3))  # (Cout, 1, 1, 1)
    yi = int8_conv3x3_s32(xq, wq, rows_padded=split is not None)
    return (yi.float() * (sx.reshape(()) * sw.reshape(1, -1, 1, 1))).to(x.dtype)


def _conv_vjp(g, x, w, mask, pad_h: int = 1):
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [pad_h, 1], [1, 1], False, [0, 0], 1, [mask[0], mask[1], False])
    return dx, dw


class _Int8Conv3x3(torch.autograd.Function):
    """int8 forward; backward the exact conv VJP at the unquantized operands,
    or with `int8_bwd` dx as an int8 conv of the cotangent. With a `split`,
    x is the rank's rows with their halo (H + 2 rows); the per-tensor
    scales are the max over `ranks`."""

    @staticmethod
    def forward(ctx, x, w, int8_bwd, split, ranks):
        ctx.save_for_backward(x, w)
        ctx.int8_bwd, ctx.split, ctx.ranks = int8_bwd, split, ranks
        return _int8_conv(x, w, split, ranks)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        split = ctx.split
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.contiguous()
        pad_h = 1 if split is None else 0
        if not ctx.int8_bwd:
            dx, dw = _conv_vjp(g, x, w, (need_x, need_w), pad_h)
            return dx, dw, None, None, None
        dx = dw = None
        if need_x:
            wt = w.flip(2, 3).transpose(0, 1)  # (Cin, Cout, 3, 3)
            if split is None:
                dx = _int8_conv(g, wt, ranks=ctx.ranks).to(x.dtype)
            else:  # the rank's rows from the cotangent's halo; none for x's halo rows
                dx = _int8_conv(halo_rows(g, split), wt, split, ctx.ranks)
                dx = F.pad(dx, (0, 0, 1, 1)).to(x.dtype)
        if need_w:
            _, dw = _conv_vjp(g, x, w, (False, True), pad_h)
        return dx, dw, None, None, None


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, int8_bwd: bool = False) -> torch.Tensor:
    """int8 forward, straight-through backward (`int8_bwd`: dx in int8 too)."""
    return _Int8Conv3x3.apply(x, w, int8_bwd, None, None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """The dispatched 3x3 conv (NCHW x OIHW), + bias when given. Under a
    spatial split (`ops.split`) x is the rank's rows: every mode takes one
    row of each neighbour (zeros at the image's edges) and pads the width
    only."""
    mode, split = _SETTINGS["mode"], current()
    rows = x.shape[2] * (1 if split is None else split.size)  # the whole map's
    if mode == "int8" or (mode == "int8_large" and rows >= _SETTINGS["min_h"]):
        path = "int8"
    else:
        path = "shift9" if mode == "shift9" else "xla"
    CALL_COUNTS[path] += 1
    if split is not None:
        x = halo_rows(x, split)
    if path == "xla":
        return conv3x3_xla(x, w, bias) if split is None else F.conv2d(x, w, bias, padding=(0, 1))
    if path == "int8":
        y = _Int8Conv3x3.apply(x, w, _SETTINGS["int8_bwd"], split, tensor_ranks())
    else:
        y = conv3x3_shift9(x, w, rows_padded=split is not None)
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


class Conv3x3(nn.Conv2d):
    """Stride 1, SAME padding; weight (O, I, 3, 3) under diffusers' key
    names; forward through `conv3x3`."""

    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__(in_channels, out_channels, 3, padding=1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3(x, self.weight, self.bias)
