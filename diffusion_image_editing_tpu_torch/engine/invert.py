"""Inversion loops: the port of `engine/invert.py`.

* `ddim_invert`: deterministic x_0 -> x_T, with optional fixed-point
  refinement toward the exact inverse of the DDIM step.
* Edit-friendly DDPM inversion (arXiv 2304.06140): the forward trajectory
  x_1:T is sampled independently per timestep, then each step's noise map
  z_t = (x_{t-1} - mu_hat_t) / sigma_t is extracted, one step at a time
  (`ddpm_invert`) or timesteps batched together (`ddpm_invert_batched`);
  `ddpm_sample` re-generates from the extracted maps.

One host loop serves each of the JAX package's scan and split forms. The
random draw is an explicit `noise` tensor or a `torch.Generator`, so a test
can hand both frameworks the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import schedule as S
from .denoise import EpsFn


def ddim_invert(
    sched: S.Schedule,
    eps_fn: EpsFn,
    x0: torch.Tensor,
    num_steps: Optional[int] = None,
    refine_iters: int = 0,
) -> torch.Tensor:
    """x_T <- x_0 by DDIM inversion over the last `num_steps` (default all)
    timesteps, ascending. `refine_iters` = m > 0 refines each step m times,
    eps <- eps_fn(x_t_est, t); x_t_est <- next_step(x_{t-1}, eps, t), toward
    the x_t whose DDIM step reproduces x_{t-1} exactly: m more UNet calls a
    step."""
    n = num_steps or sched.num_inference_steps
    x = x0
    for t in sched.timesteps[-n:][::-1]:
        t = int(t)
        x_next = S.next_step(sched, x, eps_fn(x, t), t)
        for _ in range(refine_iters):
            x_next = S.next_step(sched, x, eps_fn(x_next, t), t)
        x = x_next
    return x


class InversionResult(NamedTuple):
    xt: torch.Tensor  # inverted latent x_T, (B, C, H, W)
    zs: Optional[torch.Tensor]  # per-step noise maps, (S, B, C, H, W); None at eta = 0
    xts: Optional[torch.Tensor]  # trajectory, x0 last, (S + 1, B, C, H, W)


def sample_xts(sched: S.Schedule, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward diffusion P(x_1:T | x_0), independent per timestep: (S+1, B,
    ...) with xts[i] at timesteps[i] (0 noisiest) and xts[S] = x0. f32 by
    contract (near t ~ 0, sqrt(1 - a) in bf16 rounds to 0). `noise`
    (S, *x0.shape) replaces the draw from `generator`."""
    n = sched.num_inference_steps
    x0 = x0.float()
    if noise is None:
        noise = torch.randn((n,) + tuple(x0.shape), generator=generator, device=x0.device,
                            dtype=torch.float32)
    elif tuple(noise.shape) != (n,) + tuple(x0.shape):
        raise ValueError(f"noise must be {(n,) + tuple(x0.shape)}, got {tuple(noise.shape)}")
    a = S.alpha_bar(sched, sched.timesteps).to(x0.device).reshape((n,) + (1,) * x0.dim())
    xts = torch.sqrt(a) * x0[None] + torch.sqrt(1.0 - a) * noise.to(x0.device, torch.float32)
    return torch.cat([xts, x0[None]], dim=0)


def _trajectory(sched, x0, generator, noise, xts):
    if xts is not None:
        return xts
    if generator is None and noise is None:
        # As the JAX package: no silent draw from torch's global generator.
        raise ValueError("eta > 0 requires generator, noise or precomputed xts")
    return sample_xts(sched, x0, generator=generator, noise=noise)


def ddpm_invert(
    sched: S.Schedule,
    eps_fn: EpsFn,
    x0: torch.Tensor,
    eta: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    xts: Optional[torch.Tensor] = None,
    start: int = 0,
) -> InversionResult:
    """Sequential edit-friendly DDPM inversion, one UNet call per timestep.
    eta == 0 degenerates to the deterministic forward-step loop; eta > 0
    needs `generator`, `noise` or a precomputed `xts`. `start=k` extracts z
    only for timestep indices >= k, as `ddpm_invert_batched` does."""
    ts = sched.timesteps
    n = sched.num_inference_steps
    start = int(start)
    if not 0 <= start < n:
        raise ValueError(f"start must be in [0, {n}), got {start}")
    if eta == 0:
        x = x0
        for t in ts[::-1]:
            x = S.forward_step(sched, x, eps_fn(x, int(t)), int(t))
        return InversionResult(x, None, None)
    xts = _trajectory(sched, x0, generator, noise, xts)
    zs, xtm1 = [], []
    for idx in range(start, n):
        t = int(ts[idx])
        eps = eps_fn(xts[idx], t)
        mu, sigma = S.posterior_mean_from_eps(sched, xts[idx], eps, t, eta)
        z = (xts[idx + 1] - mu) / sigma
        zs.append(z)
        xtm1.append(mu + sigma * z)  # eq.-3 correction: the identity in exact arithmetic
    zs[-1] = torch.zeros_like(zs[-1])
    zs = torch.stack(zs)
    if start:
        zs = torch.cat([zs.new_zeros((start,) + tuple(zs.shape[1:])), zs])
    xts_out = torch.cat([xts[:start + 1], torch.stack(xtm1)], dim=0)
    return InversionResult(xts_out[0], zs, xts_out)


def ddpm_invert_batched(
    sched: S.Schedule,
    eps_fn: EpsFn,
    x0: torch.Tensor,
    eta: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    xts: Optional[torch.Tensor] = None,
    chunk: int = 10,
    start: int = 0,
) -> InversionResult:
    """`ddpm_invert` with the z extraction parallel across timesteps.

    Each step reads only the sampled trajectory (xts[idx], xts[idx+1]), so
    the steps are independent: `chunk` timesteps at a time run as ONE UNet
    call of chunk*B samples with per-sample timesteps. `start=k` extracts z
    only for timestep indices >= k (an edit that skips its first k steps
    reads nothing else): `zs[:k]` come back zero and `xts[1:k+1]` raw."""
    n = sched.num_inference_steps
    if eta == 0:
        return ddpm_invert(sched, eps_fn, x0, eta=0.0)
    start = int(start)
    if not 0 <= start < n:
        raise ValueError(f"start must be in [0, {n}), got {start}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    xts = _trajectory(sched, x0, generator, noise, xts)

    b = x0.shape[0]
    sample_shape = tuple(x0.shape[1:])
    n_ext = n - start
    group = min(int(chunk), n_ext) * b
    total = n_ext * b
    x_flat = xts[start:-1].reshape((total,) + sample_shape)
    xn_flat = xts[start + 1:].reshape((total,) + sample_shape)
    ts_flat = torch.as_tensor(sched.timesteps[start:], device=x0.device).repeat_interleave(b)

    zs_parts, xtm1_parts = [], []
    for g0 in range(0, total, group):
        x, xn, t = x_flat[g0:g0 + group], xn_flat[g0:g0 + group], ts_flat[g0:g0 + group]
        eps = eps_fn(x, t)
        mu, sigma = S.posterior_mean_from_eps(sched, x, eps, t, eta)
        z = (xn - mu) / sigma
        zs_parts.append(z)
        xtm1_parts.append(mu + sigma * z)
    zs = torch.cat(zs_parts).reshape((n_ext, b) + sample_shape)
    xtm1 = torch.cat(xtm1_parts).reshape((n_ext, b) + sample_shape)
    zs[-1] = 0.0
    if start:
        zs = torch.cat([zs.new_zeros((start, b) + sample_shape), zs])
    xts_out = torch.cat([xts[:start + 1], xtm1], dim=0)
    return InversionResult(xts_out[0], zs, xts_out)


def ddpm_sample(
    sched: S.Schedule,
    eps_fn: EpsFn,
    zs: torch.Tensor,
    xts: torch.Tensor,
    t_skip: int = 36,
    eta: float = 1.0,
    collect: bool = False,
):
    """Re-generate from extracted noise maps: start at xts[t_skip], consume
    zs[t_skip:], one `reverse_step` a timestep. Returns x_0, and with
    `collect` also the (S - t_skip, B, C, H, W) trajectory after each step.

    The round trip reproduces the inversion's trajectory at every step but
    the last: zs[-1] is zeroed, so the last step returns the model's pred-x0
    rather than x_0 (as the reference)."""
    zs_used = zs[t_skip:]
    x = xts[t_skip]
    traj = []
    for i, t in enumerate(sched.timesteps[-zs_used.shape[0]:]):
        t = int(t)
        x, _ = S.reverse_step(sched, x, eps_fn(x, t), t, eta=eta,
                              noise=zs_used[i] if eta > 0 else None)
        if collect:
            traj.append(x)
    return (x, torch.stack(traj)) if collect else x
