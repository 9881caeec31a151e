"""Guided editing loop: the port of `engine/edit.py` (`edit_split` and
`edit`).

Each step runs the (CFG) UNet without gradient, takes a `reverse_step`
("ddpm", the DDPM + t_skip branch) or `ddim_step` ("ddim") update, then the
attribute function's nudge: a gradient through decode and loss. The JAX
package has two forms of the loop, one jitted scan (`edit`) and a host loop
of jitted steps (`edit_split`); in torch there is one host loop,
`edit_split`, which also serves unguided generation, and `edit` only adds
the JAX signature to it."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import schedule as S
from ..guidance.attr_functions import AttrFunc, DecodeFn
from .denoise import DecodeClosure, EpsFn


class EditResult(NamedTuple):
    x0: torch.Tensor  # final latent
    xts: Optional[torch.Tensor] = None
    model_outputs: Optional[torch.Tensor] = None
    pred_original_samples: Optional[torch.Tensor] = None


def edit_split(
    sched: S.Schedule,
    eps_fn: EpsFn,
    xt: torch.Tensor,
    eta: float = 0.0,
    zs: Optional[torch.Tensor] = None,
    attr_func: Optional[AttrFunc] = None,
    decode_fn: Optional[DecodeFn] = None,
    mask: Optional[torch.Tensor] = None,
    x0_ref: Optional[torch.Tensor] = None,
    step_rule: str = "ddim",
    collect: bool = False,
    num_steps: Optional[int] = None,
    encoder_reuse: int = 1,
) -> EditResult:
    """Guided denoising over the last n timesteps, one host step at a time:
    n = `num_steps`, else len(zs), else the schedule's; zs[-n:] is the
    per-step variance noise. t_skip is applied by the caller slicing
    xt = xts[t_skip] and zs = zs[t_skip:]. With no `attr_func` this is the
    generation loop (`engine.denoise.generate`).

    `encoder_reuse=k > 1`: encoder propagation (Faster Diffusion, arXiv
    2312.09608). Step i (counted from the first step run) runs the eps_fn's
    `full` when i % k == 0 and keeps its down-path features; the other
    steps run `reuse` on them (mid + up only). Approximate, opt-in; needs an
    eps_fn with `full` / `reuse` (`CfgEpsFeatClosure`, `EpsFeatClosure`).
    Neither eps nor the features carry a gradient."""
    if eta > 0 and zs is None:
        raise ValueError("eta > 0 requires zs")
    if encoder_reuse > 1 and not hasattr(eps_fn, "reuse"):
        raise ValueError("encoder_reuse > 1 needs a feature-capable eps_fn "
                         "(engine.denoise.CfgEpsFeatClosure/EpsFeatClosure)")
    if step_rule not in ("ddim", "ddpm"):
        raise ValueError(f"Unknown step rule {step_rule!r}")
    n = num_steps if num_steps is not None else (
        zs.shape[0] if zs is not None else sched.num_inference_steps)
    zs = zs[-n:] if zs is not None else None
    step = S.reverse_step if step_rule == "ddpm" else S.ddim_step
    if decode_fn is None:
        decode_fn = DecodeClosure()  # identity codec
    x = xt
    xts_out, eps_out, px0_out = [], [], []
    feats = None
    for i, t in enumerate(sched.timesteps[-n:]):
        t = int(t)
        z = zs[i] if zs is not None else torch.zeros_like(x)
        if encoder_reuse > 1 and i % encoder_reuse:
            eps = eps_fn.reuse(x, t, feats).detach()
        elif encoder_reuse > 1:
            eps, feats = eps_fn.full(x, t)
            eps = eps.detach()
        else:
            eps = eps_fn(x, t).detach()
        x, px0 = step(sched, x, eps, t, eta=eta, noise=z if eta > 0 else None)
        if attr_func is not None:
            x, z = attr_func.apply_batched(x, z, eps, t, i, sched, decode_fn,
                                           mask=mask, x0=x0_ref)
        if collect:
            xts_out.append(x)
            eps_out.append(eps)
            px0_out.append(px0)
    if collect:
        return EditResult(x, torch.stack(xts_out), torch.stack(eps_out), torch.stack(px0_out))
    return EditResult(x)


def edit(
    sched: S.Schedule,
    eps_fn: EpsFn,
    xt: torch.Tensor,
    eta: float = 0.0,
    zs: Optional[torch.Tensor] = None,
    attr_func: Optional[AttrFunc] = None,
    decode_fn: Optional[DecodeFn] = None,
    mask: Optional[torch.Tensor] = None,
    x0_ref: Optional[torch.Tensor] = None,
    step_rule: str = "ddim",
    collect: bool = False,
    encoder_reuse: int = 1,
) -> EditResult:
    """The whole guided loop in one call (the JAX package's `mode="fused"`
form): `edit_split`'s loop."""
    return edit_split(sched, eps_fn, xt, eta=eta, zs=zs, attr_func=attr_func,
                      decode_fn=decode_fn, mask=mask, x0_ref=x0_ref, step_rule=step_rule,
                      collect=collect, encoder_reuse=encoder_reuse)
