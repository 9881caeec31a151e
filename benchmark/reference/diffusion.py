"""The plain float32 reference of what the benchmark's cells drive: the
DDPM/DDIM schedule, DDIM inversion, edit-friendly DDPM inversion (arXiv
2304.06140, noise maps extracted from a trajectory sampled per timestep),
the DDIM / edit-friendly reverse steps, classifier-free guidance, and the
two guidance nudges (colour, attribute classifier), each the gradient of a
loss on the decoded pred-x0 times alpha_bar_t^2.

Written from the published algorithms (diffusers' `DDIMScheduler.step`,
the edit-friendly inversion's eta * variance quirk) and independent of the
program under test: it imports neither JAX nor the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas_cumprod: torch.Tensor  # (T,) f32
    final_alpha_cumprod: torch.Tensor  # () f32: alpha_bar at t < 0
    timesteps: tuple  # descending ints
    num_train_timesteps: int

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // len(self.timesteps)


def make_schedule(cfg: dict, num_inference_steps: int, device) -> Schedule:
    """`cfg`: num_train_timesteps, beta_start, beta_end, beta_schedule
    (linear | scaled_linear), steps_offset, set_alpha_to_one; the timesteps
    are spaced "leading", as diffusers' DDIM scheduler."""
    n = cfg["num_train_timesteps"]
    if cfg["beta_schedule"] == "linear":
        betas = torch.linspace(cfg["beta_start"], cfg["beta_end"], n, dtype=torch.float32)
    elif cfg["beta_schedule"] == "scaled_linear":
        betas = torch.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                               dtype=torch.float32) ** 2
    else:
        raise ValueError(f"unknown beta_schedule {cfg['beta_schedule']!r}")
    ac = torch.cumprod(1.0 - betas, dim=0)
    final = torch.tensor(1.0) if cfg["set_alpha_to_one"] else ac[0].clone()
    ratio = n // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio)[::-1] + cfg["steps_offset"]
    return Schedule(ac.to(device), final.to(device), tuple(int(t) for t in ts), n)


def _t(s: Schedule, t) -> torch.Tensor:
    return torch.as_tensor(t, device=s.alphas_cumprod.device).long()


def alpha_bar(s: Schedule, t, like: torch.Tensor) -> torch.Tensor:
    """alpha_bar_t as an f32 tensor broadcastable to `like` (t a scalar or
    one value a sample); t < 0 reads the final alpha."""
    t = _t(s, t)
    a = torch.where(t >= 0, s.alphas_cumprod[t.clamp(0, s.num_train_timesteps - 1)],
                    s.final_alpha_cumprod)
    return a.reshape((-1,) + (1,) * (like.dim() - 1)) if a.dim() == 1 else a


def variance(s: Schedule, t, like) -> torch.Tensor:
    a_t = alpha_bar(s, t, like)
    a_prev = alpha_bar(s, _t(s, t) - s.step_ratio, like)
    return ((1.0 - a_prev) / (1.0 - a_t)) * (1.0 - a_t / a_prev)


def pred_x0(s: Schedule, x, eps, t) -> torch.Tensor:
    a_t = alpha_bar(s, t, x)
    return (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)


def ddim_step(s: Schedule, x, eps, t) -> torch.Tensor:
    """DDIM at eta 0."""
    a_prev = alpha_bar(s, _t(s, t) - s.step_ratio, x)
    direction = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
    return torch.sqrt(a_prev) * pred_x0(s, x, eps, t) + direction


def reverse_step(s: Schedule, x, eps, t, eta: float, noise) -> torch.Tensor:
    """The edit-friendly reverse step: eta * variance (not eta^2) in the
    direction term, eta * sigma_t * z added."""
    a_prev = alpha_bar(s, _t(s, t) - s.step_ratio, x)
    var = variance(s, t, x)
    direction = torch.sqrt(torch.clamp(1.0 - a_prev - eta * var, min=0.0)) * eps
    return torch.sqrt(a_prev) * pred_x0(s, x, eps, t) + direction + eta * torch.sqrt(var) * noise


def posterior_mean(s: Schedule, x, eps, t, eta: float):
    """(mu_hat_t, sigma_t): x_{t-1} = mu + sigma * z."""
    a_prev = alpha_bar(s, _t(s, t) - s.step_ratio, x)
    var = variance(s, t, x)
    direction = torch.sqrt(torch.clamp(1.0 - a_prev - eta * var, min=0.0)) * eps
    return torch.sqrt(a_prev) * pred_x0(s, x, eps, t) + direction, eta * torch.sqrt(var)


def next_step(s: Schedule, x, eps, t: int) -> torch.Tensor:
    """DDIM inversion x_{t - ratio} -> x_t."""
    cur = min(t - s.step_ratio, s.num_train_timesteps - 1)
    a_t, a_next = alpha_bar(s, cur, x), alpha_bar(s, t, x)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * eps


EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cfg_eps(unet, ctx: torch.Tensor, scale: float) -> EpsFn:
    """Classifier-free guidance: `ctx` is [uncond; cond], (2, L, D)."""
    def eps(x, t):
        b = x.shape[0]
        t = torch.as_tensor(t, device=x.device).long()
        t = t.expand(b) if t.dim() == 0 else t
        out = unet(torch.cat([x, x]), torch.cat([t, t]), ctx.repeat_interleave(b, dim=0))
        u, c = out.chunk(2)
        return u + scale * (c - u)
    return eps


def plain_eps(unet) -> EpsFn:
    def eps(x, t):
        t = torch.as_tensor(t, device=x.device).long()
        return unet(x, t.expand(x.shape[0]) if t.dim() == 0 else t)
    return eps


def ddim_invert(s: Schedule, eps_fn: EpsFn, x0: torch.Tensor,
                record: Optional[list] = None) -> torch.Tensor:
    """x_T from x_0; `record` keeps the state each step starts from."""
    x = x0
    for t in s.timesteps[::-1]:
        if record is not None:
            record.append(x)
        x = next_step(s, x, eps_fn(x, t), t)
    return x


def sample_xts(s: Schedule, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The forward trajectory (S + 1, B, ...): xts[i] at timesteps[i], x0 last."""
    a = alpha_bar(s, torch.tensor(s.timesteps), noise[:, 0])
    a = a.reshape((-1,) + (1,) * x0.dim())
    return torch.cat([torch.sqrt(a) * x0[None] + torch.sqrt(1.0 - a) * noise, x0[None]])


def ddpm_extract(s: Schedule, eps_fn: EpsFn, xts: torch.Tensor, start: int, eta: float,
                 chunk: int) -> torch.Tensor:
    """The noise maps z for timestep indices >= start, (S - start, B, ...),
    the last zeroed; `chunk` timesteps a UNet call."""
    n, b = len(s.timesteps), xts.shape[1]
    zs = []
    for i0 in range(start, n, chunk):
        idx = list(range(i0, min(i0 + chunk, n)))
        x = xts[idx].reshape((-1,) + tuple(xts.shape[2:]))
        xn = xts[[i + 1 for i in idx]].reshape(x.shape)
        t = torch.tensor([s.timesteps[i] for i in idx], device=x.device).repeat_interleave(b)
        mu, sigma = posterior_mean(s, x, eps_fn(x, t), t, eta)
        zs.append(((xn - mu) / sigma).reshape((len(idx), b) + tuple(xts.shape[2:])))
    zs = torch.cat(zs)
    zs[-1] = 0.0
    return zs


def colour_loss(decoded: torch.Tensor, target: float, channel: int) -> torch.Tensor:
    """Per sample: the mean absolute error of one channel against `target`."""
    return (decoded[:, channel].float() - target).abs().mean(dim=(1, 2))


def loss_grad(decode: Callable, loss: Callable, z: torch.Tensor,
              scales: Sequence[float]) -> torch.Tensor:
    """d(sum_i scales[i] * loss(decode(z))_i) / dz at the decoder's input z;
    `loss` returns one value a sample."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        per = loss(decode(zg))
        total = (per * torch.tensor(list(scales), device=z.device, dtype=per.dtype)).sum()
        (grad,) = torch.autograd.grad(total, zg)
    return grad


def vjp(fn: Callable, x: torch.Tensor, cotangent: torch.Tensor) -> torch.Tensor:
    """The vector-Jacobian product of `fn` at x with `cotangent`."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(xg), xg, grad_outputs=cotangent)
    return grad


def guided_loop(s: Schedule, eps_fn: EpsFn, x: torch.Tensor, timesteps: Sequence[int],
                step: Callable, decode: Callable, loss: Callable, scales: Sequence[float],
                window: range, record: Optional[dict] = None) -> torch.Tensor:
    """The guided denoising loop: at step i (timestep t) eps = eps_fn(x, t),
    x <- step(i, x, eps, t), then, when i lies in `window`, the nudge
    -grad_x(loss) * alpha_bar_t^2 with the loss taken at the decoded
    z = pred_x0(x, eps) (so grad_x = dL/dz / sqrt(alpha_bar_t)); eps is held
    fixed. `record` (lists under "eps", "px0", "x_in", "x_out", "dec_in",
    "dec_grad") keeps each step's eps and pred-x0 before the step, the
    state after the step and after its nudge, and each nudge's z and
    dL/dz."""
    for i, t in enumerate(timesteps):
        with torch.no_grad():
            eps = eps_fn(x, t)
        if record is not None:
            record["eps"].append(eps)
            record["px0"].append(pred_x0(s, x, eps, t))
        x = step(i, x, eps, t)
        if record is not None:
            record["x_in"].append(x)
        if any(scales) and i in window:
            z = pred_x0(s, x, eps, t)
            g = loss_grad(decode, loss, z, scales)
            a = alpha_bar(s, t, x)
            x = x - g / torch.sqrt(a) * a ** 2
            if record is not None:
                record["dec_in"].append(z)
                record["dec_grad"].append(g)
        if record is not None:
            record["x_out"].append(x)
    return x
