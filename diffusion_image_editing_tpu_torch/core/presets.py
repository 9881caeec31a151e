"""Scheduler presets per model family: the port of `core/presets.py`."""

from __future__ import annotations

from typing import Any, Dict

from .schedule import Schedule, make_schedule

SCHEDULE_PRESETS: Dict[str, Dict[str, Any]] = {
    "ddpm": dict(num_train_timesteps=1000, beta_start=0.0001, beta_end=0.02,
                 beta_schedule="linear", steps_offset=0, set_alpha_to_one=True,
                 clip_sample=True),
    "ldm": dict(num_train_timesteps=1000, beta_start=0.0015, beta_end=0.0195,
                beta_schedule="scaled_linear", steps_offset=0, set_alpha_to_one=True,
                clip_sample=False),
    "sd": dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
               beta_schedule="scaled_linear", steps_offset=1, set_alpha_to_one=False,
               clip_sample=False),
    # stabilityai/stable-diffusion-xl-base-1.0 `scheduler/scheduler_config.json`
    # (EulerDiscrete's betas and offset; the port steps them as DDIM)
    "sdxl": dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                 beta_schedule="scaled_linear", steps_offset=1, set_alpha_to_one=False,
                 clip_sample=False),
}


def schedule_for_model(name: str, num_inference_steps: int = 50,
                       clip_sample: bool | None = None, device=None) -> Schedule:
    """The family's schedule; `clip_sample` overrides the preset (real-image
    editing runs unclipped)."""
    if name not in SCHEDULE_PRESETS:
        raise ValueError(f"Unknown model family {name!r}; choose from {list(SCHEDULE_PRESETS)}")
    kwargs = dict(SCHEDULE_PRESETS[name])
    if clip_sample is not None:
        kwargs["clip_sample"] = clip_sample
    return make_schedule(num_inference_steps=num_inference_steps, device=device, **kwargs)
