"""Activated batch norm (ABN) over NCHW: the plain torch version and the
hand-written CUDA kernel K8.

ABN is batch norm with a |weight| affine and the activation fused in:
y = act((x - mean) * rstd * |weight| + bias), act one of identity,
leaky_relu (slope 0.01) or elu, statistics per channel over (N, H, W). The
JAX package's `ops/abn.py` is the reference; its contracts hold here:

* `mean_var` is the single-pass E[x^2] - mean^2 in f32;
* the training backward is the two-phase one of `_fused_abn_bwd`: dz, then
  the per-channel means edz = E[dz] and eydz = E[xhat * dz], then
  dx = (dz - edz - xhat * eydz) * |w| * rstd, with dweight = sign(w) *
  sum(xhat * dz) and dbias = sum(dz);
* the running statistics take the unbiased variance var * n / (n - 1),
  n = N * H * W, with momentum 0.1; eps is 1e-5.

K8 (`csrc/abn_apply.cu`, built by `ops._build`) replaces the TPU kernel
`_abn_apply_kernel` (diffusion_image_editing_tpu/ops/abn.py): the
normalise + |w| affine + activation pass, in f32 and in JAX's order, for f32
or bf16 x with f32 per-channel mean, rstd, weight and bias. It is bound by
bytes: it reads x once and writes y once. The statistics and the backward
are torch ops, as they are jnp ops in the JAX package.

`abn_apply()` launches K8 on a CUDA tensor, or raises; `abn_apply_reference`
is its plain version, which the autograd functions take for a CPU tensor
only. The wrapper counts its launches in the tracer's
counter `ops.launches.abn_apply`.

Synced statistics (the reference's InPlaceABNSync): `axis_name` is a
process group, or a 1-D device mesh (a mesh dimension, `mesh["dp"]`) whose
group is taken. The per-channel means of `mean_var` and `edz_eydz` are
all-reduced to the group's means (the JAX package's `pmean`), the
training backward's dweight and dbias are the group's sums (its `psum`),
and the running variance's unbiased count is n times the group's size.
Every rank must hold the same number of samples.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from ..utils.logging import COUNTERS
from . import _build

ACTS = ("identity", "leaky_relu", "elu")  # codes 0-2 of csrc/abn_apply.cu
AxisName = Optional[Union[dist.ProcessGroup, DeviceMesh]]


def _group(axis_name: AxisName) -> Optional[dist.ProcessGroup]:
    return axis_name.get_group() if isinstance(axis_name, DeviceMesh) else axis_name


def group_size(axis_name: AxisName) -> int:
    """The number of ranks the statistics are synced over (1 unsynced)."""
    return 1 if axis_name is None else dist.get_world_size(_group(axis_name))


def _group_mean(tensors: Sequence[torch.Tensor], axis_name: AxisName):
    """Each (C,) f32 tensor's mean over the group's ranks, from one
    all-reduce of them packed together; unchanged without a group."""
    if axis_name is None:
        return tuple(tensors)
    packed = torch.stack(tensors)
    dist.all_reduce(packed, group=_group(axis_name))
    return tuple(packed / group_size(axis_name))


def _check_act(activation: str) -> None:
    if activation not in ACTS:
        raise ValueError(f"Unknown activation {activation!r}; have {ACTS}")


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) tensor shaped to broadcast over (N, C, *spatial)."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _act_forward(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == "identity":
        return y
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    if activation == "elu":
        return torch.where(y >= 0, y, torch.expm1(y))
    raise ValueError(f"Unknown activation {activation!r}; have {ACTS}")


def _act_grad_from_linear(y_lin: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    """d act / d y_lin from the pre-activation value."""
    if activation == "identity":
        return torch.ones_like(y_lin)
    if activation == "leaky_relu":
        return torch.where(y_lin >= 0, 1.0, slope)
    if activation == "elu":
        return torch.where(y_lin >= 0, 1.0, torch.exp(y_lin))
    raise ValueError(f"Unknown activation {activation!r}; have {ACTS}")


def invert_activation(y_act: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    """The pre-activation value from the activated output (the in-place
    trick of InPlace-ABN, kept as a capability)."""
    if activation == "identity":
        return y_act
    if activation == "leaky_relu":
        return torch.where(y_act >= 0, y_act, y_act / slope)
    if activation == "elu":
        return torch.where(y_act >= 0, y_act, torch.log1p(y_act))
    raise ValueError(f"Unknown activation {activation!r}; have {ACTS}")


def mean_var(x: torch.Tensor, axis_name: AxisName = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 mean and variance of an (N, C, *spatial) tensor over
    every dimension but C, as E[x^2] - mean^2 (one pass, JAX's form); with
    `axis_name`, E[x] and E[x^2] are the group's means."""
    xf = x.float()
    dims = _reduce_dims(x)
    mean, sq = _group_mean((xf.mean(dims), (xf * xf).mean(dims)), axis_name)
    return mean, sq - mean * mean


def edz_eydz(xhat: torch.Tensor, dz: torch.Tensor,
             axis_name: AxisName = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's per-channel reductions edz = E[dz], eydz = E[xhat * dz],
    the group's means with `axis_name`."""
    dims = _reduce_dims(dz)
    dzf = dz.float()
    return _group_mean((dzf.mean(dims), (xhat.float() * dzf).mean(dims)), axis_name)


# ---------------------------------------------------------------------------
# K8 and its plain version
# ---------------------------------------------------------------------------


def abn_apply_reference(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        activation: str = "leaky_relu", slope: float = 0.01) -> torch.Tensor:
    """act((x - mean) * rstd * |weight| + bias) in f32, per channel of an
    (N, C, *spatial) x, cast to x's dtype: the plain version of K8."""
    _check_act(activation)
    nd = x.dim()
    y = (x.float() - _channel_view(mean.float(), nd)) * _channel_view(rstd.float(), nd)
    y = y * _channel_view(weight.float().abs(), nd) + _channel_view(bias.float(), nd)
    return _act_forward(y, activation, slope).to(x.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# device, x, x_bf16, mean, rstd, weight, bias, out, N, C, HW, act, slope, stream
_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]


def abn_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, activation: str = "leaky_relu",
              slope: float = 0.01) -> torch.Tensor:
    """K8: `abn_apply_reference` on the card. x: contiguous (N, C, *spatial)
    f32 or bf16 CUDA tensor; mean, rstd, weight, bias: contiguous (C,) f32 on
    x's device. Returns y in x's dtype; raises on anything else."""
    _check_act(activation)
    if not x.is_cuda:
        raise ValueError(f"abn_apply: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"abn_apply: K8 takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"abn_apply: x must be a contiguous (N, C, ...) tensor, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    if x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"abn_apply: shape {tuple(x.shape)} is out of K8's range")
    for name, t in (("mean", mean), ("rstd", rstd), ("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"abn_apply: {name} must be contiguous float32 ({c},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    _build.launch("abn_apply", _ARGTYPES, x.device, x.data_ptr(),
                  int(x.dtype == torch.bfloat16), mean.data_ptr(), rstd.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, hw,
                  ACTS.index(activation), float(slope))
    COUNTERS["ops.launches.abn_apply"] += 1
    return out


def _apply(x, mean, rstd, weight, bias, activation, slope):
    """K8 for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return abn_apply(x, mean, rstd, weight, bias, activation, slope)
    if x.device.type == "cpu":
        return abn_apply_reference(x, mean, rstd, weight, bias, activation, slope)
    raise ValueError(f"abn_apply: no kernel for device {x.device}")


def abn_backward(grad: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, rstd: torch.Tensor, activation: str, slope: float,
                 training: bool, needs: Sequence[bool] = (True, True, True),
                 axis_name: AxisName = None):
    """(dx, dweight, dbias) of y = act(xhat * |w| + b), xhat = (x - mean) *
    rstd, in f32 torch ops (`_fused_abn_bwd`). `training`: mean and rstd are
    x's own batch statistics, so dx carries their gradient (the edz and eydz
    terms); otherwise they are constants (the running statistics). With
    `axis_name` (training only), edz and eydz are the group's means and
    dweight, dbias the group's sums: count x ranks x the means."""
    nd = x.dim()
    xhat = ((x.float() - _channel_view(mean, nd)) * _channel_view(rstd, nd)).to(x.dtype).float()
    wabs = weight.float().abs()
    y_lin = xhat * _channel_view(wabs, nd) + _channel_view(bias.float(), nd)
    dz = grad.float() * _act_grad_from_linear(y_lin, activation, slope)
    del y_lin
    edz, eydz = edz_eydz(xhat, dz, axis_name)
    count = x.numel() // x.shape[1] * group_size(axis_name)
    dx = None
    if needs[0]:
        if training:
            dz_c = dz - _channel_view(edz, nd) - xhat * _channel_view(eydz, nd)
        else:
            dz_c = dz
        dx = (dz_c * _channel_view(wabs * rstd, nd)).to(x.dtype)
    dweight = (torch.sign(weight.float()) * eydz * count).to(weight.dtype) if needs[1] else None
    dbias = (edz * count).to(bias.dtype) if needs[2] else None
    return dx, dweight, dbias


class FusedABNTrain(torch.autograd.Function):
    """Training-mode ABN: batch statistics by `mean_var` (synced over
    `axis_name` when given), then K8 (or its plain version on the CPU); the
    backward is `abn_backward` from x and the saved f32 mean and rstd.
    Returns (y, mean, var); mean and var carry no gradient and serve the
    running update."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, activation, slope, axis_name=None):
        mean, var = mean_var(x, axis_name)
        rstd = torch.rsqrt(var + eps)
        y = _apply(x, mean, rstd, weight, bias, activation, slope)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.activation, ctx.slope, ctx.axis_name = activation, slope, axis_name
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _grad_mean, _grad_var):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        grads = abn_backward(grad, x, weight, bias, mean, rstd, ctx.activation, ctx.slope,
                             True, ctx.needs_input_grad[:3], ctx.axis_name)
        return (*grads, None, None, None, None)


class _ABNEval(torch.autograd.Function):
    """Eval-mode ABN with given mean and rstd (the running statistics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, rstd, activation, slope):
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.activation, ctx.slope = activation, slope
        return _apply(x, mean, rstd, weight, bias, activation, slope)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        grads = abn_backward(grad, x, weight, bias, mean, rstd, ctx.activation, ctx.slope,
                             False, ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None)


def fused_abn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
              activation: str = "leaky_relu", slope: float = 0.01,
              axis_name: AxisName = None, running_mean: Optional[torch.Tensor] = None,
              running_var: Optional[torch.Tensor] = None, training: bool = True,
              momentum: float = 0.1):
    """Fused activated batch norm over (N, C, *spatial).

    Training: batch statistics, synced over `axis_name` when given;
    returns (y, new_running_mean, new_running_var), the last two None
    without running statistics. Eval: normalises with the running
    statistics; returns y."""
    _check_act(activation)
    x = x.contiguous()
    if not training:
        if running_mean is None or running_var is None:
            raise ValueError("eval mode requires running stats")
        rstd = torch.rsqrt(running_var.float() + eps)
        return _ABNEval.apply(x, weight, bias, running_mean.float().contiguous(), rstd,
                              activation, float(slope))
    y, mean, var = FusedABNTrain.apply(x, weight, bias, float(eps), activation, float(slope),
                                       axis_name)
    if running_mean is None:
        return y, None, None
    count = x.numel() // x.shape[1] * group_size(axis_name)
    with torch.no_grad():
        unbiased = var * count / max(count - 1, 1)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


class FusedABNorm(nn.Module):
    """Fused activated batch norm as a layer with running statistics:
    `weight` (ones), `bias` (zeros), buffers `running_mean` (zeros) and
    `running_var` (ones). In training mode it normalises with the batch's
    statistics and updates the running ones in place; in eval mode it uses
    the running ones. With `axis_name` (a process group or a 1-D mesh) the
    training statistics are synced over its ranks (InPlaceABNSync)."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 activation: str = "leaky_relu", slope: float = 0.01,
                 axis_name: AxisName = None, device=None):
        super().__init__()
        _check_act(activation)
        self.momentum, self.eps, self.activation, self.slope = momentum, eps, activation, slope
        self.axis_name = axis_name
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return fused_abn(x, self.weight, self.bias, self.eps, self.activation, self.slope,
                             running_mean=self.running_mean, running_var=self.running_var,
                             training=False)
        y, new_mean, new_var = fused_abn(
            x, self.weight, self.bias, self.eps, self.activation, self.slope,
            axis_name=self.axis_name, running_mean=self.running_mean,
            running_var=self.running_var, training=True, momentum=self.momentum)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)
        return y
