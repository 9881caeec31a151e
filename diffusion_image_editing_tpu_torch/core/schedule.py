"""Diffusion schedule algebra in torch: the port of `core/schedule.py`.

A `Schedule` holds precomputed f32 `alphas_cumprod` (on the device of the
samples) and the descending inference timesteps as HOST numpy int32, the
control data of the Python step loops. Every update rule is a plain function
`(sample, eps, t) -> ...` that takes `t` as a Python int, a numpy array or a
tensor, scalar or per-sample `(B,)`.

Semantics kept from the reference:
  * `ddim_step` follows diffusers' `DDIMScheduler.step` (eta^2 * variance in
    the direction term).
  * `reverse_step` keeps the edit-friendly DDPM-inversion quirk: eta * variance
    (not eta^2) in the direction term.
  * The algebra is f32 for bf16 samples: coefficients are broadcast as f32
    tensors of the sample's rank, so a bf16 sample promotes to f32 instead of
    dragging the coefficients down to bf16 (where 1 - a_prev - eta*var can
    round negative near t = 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

Timestep = Union[int, np.integer, np.ndarray, torch.Tensor]


def _betas(num_train_timesteps: int, beta_start: float, beta_end: float,
           beta_schedule: str) -> torch.Tensor:
    if beta_schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
    if beta_schedule == "scaled_linear":
        return torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                              dtype=torch.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar_fn(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [
            min(1 - alpha_bar_fn((i + 1) / num_train_timesteps)
                / alpha_bar_fn(i / num_train_timesteps), 0.999)
            for i in range(num_train_timesteps)
        ]
        return torch.tensor(betas, dtype=torch.float32)
    raise ValueError(f"Unknown beta schedule: {beta_schedule!r}")


def _inference_timesteps(num_train_timesteps: int, num_inference_steps: int,
                         timestep_spacing: str, steps_offset: int) -> np.ndarray:
    if timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        ts = ts.astype(np.int32) + steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int32) - 1
    elif timestep_spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps)
        ts = np.round(ts)[::-1].astype(np.int32)
    else:
        raise ValueError(f"Unknown timestep spacing: {timestep_spacing!r}")
    return np.ascontiguousarray(ts)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed schedule; `timesteps` descending (noisiest first), host numpy."""

    alphas_cumprod: torch.Tensor  # (T,) f32
    final_alpha_cumprod: torch.Tensor  # () f32, used when the previous timestep is < 0
    timesteps: np.ndarray  # (S,) int32, descending
    num_train_timesteps: int
    num_inference_steps: int
    clip_sample: bool
    clip_sample_range: float
    steps_offset: int = 0
    timestep_spacing: str = "leading"

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device

    def to(self, device) -> "Schedule":
        return dataclasses.replace(
            self, alphas_cumprod=self.alphas_cumprod.to(device),
            final_alpha_cumprod=self.final_alpha_cumprod.to(device))

    def with_clip_sample(self, clip_sample: bool) -> "Schedule":
        return dataclasses.replace(self, clip_sample=clip_sample)

    def with_num_inference_steps(self, num_inference_steps: int,
                                 timestep_spacing: Optional[str] = None,
                                 steps_offset: Optional[int] = None) -> "Schedule":
        """The same schedule at another step count; the spacing and offset
        are the schedule's own unless overridden."""
        spacing = self.timestep_spacing if timestep_spacing is None else timestep_spacing
        offset = self.steps_offset if steps_offset is None else steps_offset
        ts = _inference_timesteps(self.num_train_timesteps, num_inference_steps, spacing, offset)
        return dataclasses.replace(self, timesteps=ts, num_inference_steps=num_inference_steps,
                                   steps_offset=offset, timestep_spacing=spacing)


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    beta_schedule: str = "linear",
    num_inference_steps: int = 50,
    steps_offset: int = 0,
    timestep_spacing: str = "leading",
    set_alpha_to_one: bool = True,
    clip_sample: bool = True,
    clip_sample_range: float = 1.0,
    device=None,
) -> Schedule:
    """`device` places `alphas_cumprod`; None keeps it on the CPU."""
    betas = _betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    final = torch.tensor(1.0) if set_alpha_to_one else alphas_cumprod[0].clone()
    ts = _inference_timesteps(num_train_timesteps, num_inference_steps, timestep_spacing,
                              steps_offset)
    sched = Schedule(
        alphas_cumprod=alphas_cumprod, final_alpha_cumprod=final, timesteps=ts,
        num_train_timesteps=num_train_timesteps, num_inference_steps=num_inference_steps,
        clip_sample=clip_sample, clip_sample_range=clip_sample_range,
        steps_offset=steps_offset, timestep_spacing=timestep_spacing,
    )
    return sched if device is None else sched.to(device)


# ---------------------------------------------------------------------------
# Scalar schedule lookups
# ---------------------------------------------------------------------------


def _as_t(s: Schedule, t: Timestep) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                           device=s.device).long()


def alpha_bar(s: Schedule, t: Timestep) -> torch.Tensor:
    """alphas_cumprod[t], routing t < 0 to final_alpha_cumprod."""
    t = _as_t(s, t)
    safe = t.clamp(0, s.num_train_timesteps - 1)
    return torch.where(t >= 0, s.alphas_cumprod[safe], s.final_alpha_cumprod)


def prev_timestep(s: Schedule, t: Timestep) -> torch.Tensor:
    return _as_t(s, t) - s.step_ratio


def variance(s: Schedule, t: Timestep) -> torch.Tensor:
    """sigma_t^2 at eta = 1 (DDIM eq. 16)."""
    a_t = alpha_bar(s, t)
    a_prev = alpha_bar(s, prev_timestep(s, t))
    return ((1.0 - a_prev) / (1.0 - a_t)) * (1.0 - a_t / a_prev)


def bcast(scalar: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A () or (B,) f32 coefficient as a tensor of `like`'s rank on its
    device: per-sample values line up with the batch, and f32 wins type
    promotion against a bf16 sample (see the module docstring)."""
    scalar = scalar.to(device=like.device, dtype=torch.promote_types(like.dtype, torch.float32))
    if scalar.dim() == 1 and like.dim() > 1:
        return scalar.reshape((-1,) + (1,) * (like.dim() - 1))
    return scalar.reshape((1,) * like.dim())


def pred_original_sample(s: Schedule, sample, eps, t) -> torch.Tensor:
    """Predicted x0 (DDIM paper eq. 12), clipped when the schedule says so."""
    a_t = bcast(alpha_bar(s, t), sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    if s.clip_sample:
        x0 = x0.clamp(-s.clip_sample_range, s.clip_sample_range)
    return x0


# ---------------------------------------------------------------------------
# Update rules
# ---------------------------------------------------------------------------


def ddim_step(s: Schedule, sample, eps, t, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One denoising step, diffusers `DDIMScheduler.step` semantics.
    Returns (prev_sample, pred_original_sample)."""
    a_prev = bcast(alpha_bar(s, prev_timestep(s, t)), sample)
    x0 = pred_original_sample(s, sample, eps, t)
    std_dev = eta * torch.sqrt(bcast(variance(s, t), sample))
    direction = torch.sqrt(torch.clamp(1.0 - a_prev - std_dev**2, min=0.0)) * eps
    prev = torch.sqrt(a_prev) * x0 + direction
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires variance noise")
        prev = prev + std_dev * noise
    return prev, x0


def reverse_step(s: Schedule, sample, eps, t, eta: float = 0.0,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edit-friendly DDPM-inversion reverse step: direction uses
    (1 - a_prev - eta*var), identical to `ddim_step` at eta in {0, 1}."""
    a_t = bcast(alpha_bar(s, t), sample)
    a_prev = bcast(alpha_bar(s, prev_timestep(s, t)), sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    var = bcast(variance(s, t), sample)
    direction = torch.sqrt(torch.clamp(1.0 - a_prev - eta * var, min=0.0)) * eps
    prev = torch.sqrt(a_prev) * x0 + direction
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires variance noise")
        prev = prev + eta * torch.sqrt(var) * noise
    return prev, x0


def next_step(s: Schedule, sample, eps, t) -> torch.Tensor:
    """DDIM-inversion step x_{t-1} -> x_t at timestep t: the inverse of
    `ddim_step` (eta 0) at equal eps."""
    cur_t = torch.clamp(_as_t(s, t) - s.step_ratio, max=s.num_train_timesteps - 1)
    a_t = bcast(alpha_bar(s, cur_t), sample)
    a_next = bcast(alpha_bar(s, t), sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * eps


def forward_step(s: Schedule, sample, eps, t) -> torch.Tensor:
    """eta = 0 forward step of the DDPM inversion."""
    next_t = torch.clamp(_as_t(s, t) + s.step_ratio, max=s.num_train_timesteps - 2)
    a_t = bcast(alpha_bar(s, t), sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return add_noise(s, x0, eps, next_t)


def add_noise(s: Schedule, x0, noise, t) -> torch.Tensor:
    """q(x_t | x_0) mean path: sqrt(a_t) x0 + sqrt(1 - a_t) noise."""
    a_t = bcast(alpha_bar(s, t), x0)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise


def mu_tilde(s: Schedule, xt, x0, t) -> torch.Tensor:
    """Posterior mean mu~(x_t, x_0) in the reference's form (DDPM eq. 7 with
    beta_t taken as 1 - alpha_bar_t, as the JAX package keeps it)."""
    a_t = bcast(alpha_bar(s, t), xt)
    a_prev = bcast(alpha_bar(s, prev_timestep(s, t)), xt)
    beta_t = 1.0 - a_t
    return ((torch.sqrt(a_prev) * beta_t / (1.0 - a_t)) * x0
            + (torch.sqrt(a_t) * (1.0 - a_prev) / (1.0 - a_t)) * xt)


def posterior_mean_from_eps(s: Schedule, sample, eps, t,
                            eta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """mu_hat(x_t) and sigma = eta * sqrt(var): the noise-map extraction
    pieces of the edit-friendly DDPM inversion."""
    a_t = bcast(alpha_bar(s, t), sample)
    a_prev = bcast(alpha_bar(s, prev_timestep(s, t)), sample)
    x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    var = bcast(variance(s, t), sample)
    direction = torch.sqrt(torch.clamp(1.0 - a_prev - eta * var, min=0.0)) * eps
    mu = torch.sqrt(a_prev) * x0 + direction
    return mu, eta * torch.sqrt(var)
