"""The port's schedule algebra against the JAX package's, same inputs from numpy.

Tolerance: f32 on both sides; alphas_cumprod is a cumulative product whose
association differs between the two frameworks, so rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import presets as jpresets
from diffusion_image_editing_tpu.core import schedule as J
from diffusion_image_editing_tpu_torch.core import presets as tpresets
from diffusion_image_editing_tpu_torch.core import schedule as T

RTOL, ATOL = 1e-5, 1e-6
FAMILIES = ["sd", "ddpm", "ldm"]


def _scheds(family, steps=50, clip=None):
    return (jpresets.schedule_for_model(family, steps, clip_sample=clip),
            tpresets.schedule_for_model(family, steps, clip_sample=clip, device="cpu"))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_schedule_tables(family):
    js, ts = _scheds(family)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    assert isinstance(ts.timesteps, np.ndarray)
    _close(ts.alphas_cumprod, js.alphas_cumprod)
    _close(ts.final_alpha_cumprod, js.final_alpha_cumprod)
    assert ts.step_ratio == js.step_ratio


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_make_schedule_options(spacing, beta_schedule):
    kw = dict(num_inference_steps=20, timestep_spacing=spacing, beta_schedule=beta_schedule,
              steps_offset=1)
    js, ts = J.make_schedule(**kw), T.make_schedule(**kw)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    _close(ts.alphas_cumprod, js.alphas_cumprod)


@pytest.mark.parametrize("family", FAMILIES)
def test_scalar_lookups(family):
    js, ts = _scheds(family)
    t = np.concatenate([np.asarray(js.timesteps), [-19, -1, 0]]).astype(np.int32)
    _close(T.alpha_bar(ts, t), J.alpha_bar(js, jnp.asarray(t)))
    _close(T.prev_timestep(ts, t), J.prev_timestep(js, jnp.asarray(t)))
    live = np.asarray(js.timesteps)
    _close(T.variance(ts, live), J.variance(js, jnp.asarray(live)))


def _inputs(seed, shape=(2, 4, 8, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# Each case: (port function, JAX function, extra kwargs). t is scalar or (B,).
STEP_FNS = {
    "pred_original_sample": (T.pred_original_sample, J.pred_original_sample, {}),
    "ddim_step_eta0": (T.ddim_step, J.ddim_step, {"eta": 0.0}),
    "ddim_step_eta1": (T.ddim_step, J.ddim_step, {"eta": 1.0, "noise": True}),
    "ddim_step_eta05": (T.ddim_step, J.ddim_step, {"eta": 0.5, "noise": True}),
    "reverse_step_eta0": (T.reverse_step, J.reverse_step, {"eta": 0.0}),
    "reverse_step_eta1": (T.reverse_step, J.reverse_step, {"eta": 1.0, "noise": True}),
    "reverse_step_eta05": (T.reverse_step, J.reverse_step, {"eta": 0.5, "noise": True}),
    "forward_step": (T.forward_step, J.forward_step, {}),
    "add_noise": (T.add_noise, J.add_noise, {}),
    "posterior_mean_from_eps": (T.posterior_mean_from_eps, J.posterior_mean_from_eps,
                                {"eta": 1.0}),
    "next_step": (T.next_step, J.next_step, {}),
    "mu_tilde": (T.mu_tilde, J.mu_tilde, {}),  # (xt, x0) in the (sample, eps) slots
}


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("name", sorted(STEP_FNS))
@pytest.mark.parametrize("family,clip", [("sd", None), ("ddpm", True)])
def test_step_functions(name, per_sample, family, clip):
    tfn, jfn, kw = STEP_FNS[name]
    js, ts = _scheds(family, clip=clip)
    x, eps, noise = _inputs(2 * sorted(STEP_FNS).index(name) + per_sample)
    t = np.array([801, 41], np.int32) if per_sample else np.int32(401)
    if family == "ddpm":
        t = np.array([780, 20], np.int32) if per_sample else np.int32(400)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("noise", False):
        jkw["noise"], tkw["noise"] = jnp.asarray(noise), torch.from_numpy(noise)
    jout = jfn(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), **jkw)
    tout = tfn(ts, torch.from_numpy(x), torch.from_numpy(eps), t, **tkw)
    if isinstance(jout, tuple):
        for a, b in zip(tout, jout):
            _close(a, b, atol=1e-5)
    else:
        _close(tout, jout, atol=1e-5)


def test_eta_requires_noise():
    _, ts = _scheds("sd")
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError):
        T.ddim_step(ts, x, x, 401, eta=1.0)
    with pytest.raises(ValueError):
        T.reverse_step(ts, x, x, 401, eta=1.0)


def test_bf16_sample_keeps_f32_algebra():
    """A bf16 sample promotes to f32 (coefficients are never rounded to bf16)."""
    _, ts = _scheds("sd")
    x, eps, noise = (torch.from_numpy(a) for a in _inputs(3))
    prev, x0 = T.reverse_step(ts, x.bfloat16(), eps, 1, eta=1.0, noise=noise)
    assert prev.dtype == torch.float32 and x0.dtype == torch.float32
    assert torch.isfinite(prev).all()


def test_schedule_moves_and_resteps():
    _, ts = _scheds("sd")
    assert ts.to("cpu").device.type == "cpu"
    ts10 = ts.with_num_inference_steps(10)
    js10 = jpresets.schedule_for_model("sd", 10)
    np.testing.assert_array_equal(ts10.timesteps, np.asarray(js10.timesteps))
    assert not ts.with_clip_sample(False).clip_sample
    with pytest.raises(ValueError):
        tpresets.schedule_for_model("nope")


@pytest.mark.parametrize("per_sample", [False, True])
def test_next_step_inverts_ddim_step(per_sample):
    """At equal eps, the DDIM inversion step undoes the eta-0 DDIM step."""
    _, ts = _scheds("sd")
    x, eps, _ = (torch.from_numpy(a) for a in _inputs(5))
    t = np.array([801, 41], np.int32) if per_sample else 401
    prev, _ = T.ddim_step(ts, x, eps, t)
    torch.testing.assert_close(T.next_step(ts, prev, eps, t), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spacing,offset", [(None, None), ("trailing", None),
                                            ("linspace", 0), ("leading", 3)])
def test_resteps_with_spacing_and_offset_overrides(spacing, offset):
    js, ts = _scheds("sd")
    tout = ts.with_num_inference_steps(20, timestep_spacing=spacing, steps_offset=offset)
    jout = js.with_num_inference_steps(20, timestep_spacing=spacing, steps_offset=offset)
    np.testing.assert_array_equal(tout.timesteps, np.asarray(jout.timesteps))
    assert (tout.timestep_spacing, tout.steps_offset) == (jout.timestep_spacing,
                                                          jout.steps_offset)
    assert tout.with_num_inference_steps(10).timestep_spacing == tout.timestep_spacing
