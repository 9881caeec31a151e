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
`conv3x3`."""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from .split import current, halo_rows

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


def conv3x3_shift9(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """9 shifted (B*H*W, Cin) x (Cin, Cout) products, f32 accumulation."""
    b, cin, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1)  # (B, H+2, W+2, Cin)
    acc = None
    for dy in range(3):
        for dx in range(3):
            m = xp[:, dy:dy + h, dx:dx + wd].reshape(b * h * wd, cin)
            part = m.float() @ w[:, :, dy, dx].t().float()
            acc = part if acc is None else acc + part
    return acc.reshape(b, h, wd, -1).permute(0, 3, 1, 2).to(x.dtype)


def quantize_int8(v: torch.Tensor, dims) -> tuple:
    """Symmetric max-abs int8 quantization over `dims`: (q, f32 scale)."""
    a = v.float().abs().amax(dim=dims, keepdim=True)
    scale = torch.where(a > 0, a / 127.0, torch.ones_like(a))
    q = torch.clamp(torch.round(v.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv3x3_s32(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) s8 x (Cout, Cin, 3, 3) s8 -> (B, Cout, H, W) s32, SAME
    padding: `torch._int_mm` of the column matrix (B*H*W, 9*Cin) built from
    9 shifted views. Cin and Cout are padded with zeros to multiples of 8
    and the rows to more than 16 (`_int_mm`'s limits on CUDA), which is
    exact."""
    b, cin, h, wd = xq.shape
    cout = wq.shape[0]
    cp, op = _up8(cin), _up8(cout)
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, cp - cin, 1, 1, 1, 1))  # (B, H+2, W+2, Cp)
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(b * h * wd, 9 * cp)
    m = cols.shape[0]
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 32 - m))
    wmat = F.pad(wq, (0, 0, 0, 0, 0, cp - cin, 0, op - cout))  # (Op, Cp, 3, 3)
    wmat = wmat.permute(2, 3, 1, 0).reshape(9 * cp, op).contiguous()
    y = torch._int_mm(cols, wmat)[:m, :cout]
    return y.reshape(b, h, wd, cout).permute(0, 3, 1, 2)


def _int8_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantize both operands, s8 x s8 -> s32, dequantize to x.dtype."""
    xq, sx = quantize_int8(x, (0, 1, 2, 3))
    wq, sw = quantize_int8(w, (1, 2, 3))  # (Cout, 1, 1, 1)
    yi = int8_conv3x3_s32(xq, wq)
    return (yi.float() * (sx.reshape(()) * sw.reshape(1, -1, 1, 1))).to(x.dtype)


def _conv_vjp(g, x, w, mask):
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [mask[0], mask[1], False])
    return dx, dw


class _Int8Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, int8_bwd):
        ctx.save_for_backward(x, w)
        ctx.int8_bwd = int8_bwd
        return _int8_conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        g = g.contiguous()
        if not ctx.int8_bwd:
            dx, dw = _conv_vjp(g, x, w, (need_x, need_w))
            return dx, dw, None
        dx = dw = None
        if need_x:
            wt = w.flip(2, 3).transpose(0, 1)  # (Cin, Cout, 3, 3)
            dx = _int8_conv(g, wt).to(x.dtype)
        if need_w:
            _, dw = _conv_vjp(g, x, w, (False, True))
        return dx, dw, None


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, int8_bwd: bool = False) -> torch.Tensor:
    """int8 forward, straight-through backward (`int8_bwd`: dx in int8 too)."""
    return _Int8Conv3x3.apply(x, w, int8_bwd)


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """The dispatched 3x3 conv (NCHW x OIHW), + bias when given. Under a
    spatial split (`ops.split`) x is the rank's rows: it takes one
    row of each neighbour (zeros at the image's edges) and pads the width
    only; only the "xla" mode runs split."""
    mode = _SETTINGS["mode"]
    split = current()
    if split is not None:
        if mode != "xla":
            raise NotImplementedError(f"conv mode {mode!r} under a spatial split: only \"xla\" "
                                      "runs with the rows split (ROADMAP Queue A)")
        CALL_COUNTS["xla"] += 1
        return F.conv2d(halo_rows(x, split), w, bias, padding=(0, 1))
    if mode == "int8" or (mode == "int8_large" and x.shape[2] >= _SETTINGS["min_h"]):
        CALL_COUNTS["int8"] += 1
        y = conv3x3_int8(x, w, _SETTINGS["int8_bwd"])
    elif mode == "shift9":
        CALL_COUNTS["shift9"] += 1
        y = conv3x3_shift9(x, w)
    else:
        CALL_COUNTS["xla"] += 1
        return conv3x3_xla(x, w, bias)
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


class Conv3x3(nn.Conv2d):
    """Stride 1, SAME padding; weight (O, I, 3, 3) under diffusers' key
    names; forward through `conv3x3`."""

    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__(in_channels, out_channels, 3, padding=1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3(x, self.weight, self.bias)
