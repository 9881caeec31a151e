from .device import resolve_device  # noqa: F401
from .presets import SCHEDULE_PRESETS, schedule_for_model  # noqa: F401
from .schedule import (  # noqa: F401
    Schedule,
    add_noise,
    alpha_bar,
    ddim_step,
    forward_step,
    make_schedule,
    mu_tilde,
    next_step,
    posterior_mean_from_eps,
    pred_original_sample,
    prev_timestep,
    reverse_step,
    variance,
)
