"""The port's engine (DDIM and DDPM inversion, re-generation, the generation
loop, the guided edit in both forms, guidance nudges, CFG closure) against
the JAX package's, with the same numpy inputs.

The denoiser and the codec are small analytic functions written for both
frameworks (a channel mix under tanh, scaled by the timestep), so these
tests hold the engine's algebra and control flow, not the models (those
are in test_torch_models.py). Layout: JAX NHWC, port NCHW.

Tolerances: f32 on both sides. Trajectory algebra: rtol 1e-4, atol 5e-5;
z = (x_{t-1} - mu) / sigma divides by sigma ~ 0.03 at the last steps, which
scales f32 rounding up by ~30. Guidance gradients and the edit loop, which
feeds them back: rtol 1e-4, atol 5e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.engine import denoise as JD
from diffusion_image_editing_tpu.engine import invert as JI
from diffusion_image_editing_tpu.guidance import attr_functions as JA
from diffusion_image_editing_tpu_torch.core import schedule as TS
from diffusion_image_editing_tpu_torch.core import schedule_for_model as t_schedule
from diffusion_image_editing_tpu_torch.engine import denoise as TD
from diffusion_image_editing_tpu_torch.engine import edit as TE
from diffusion_image_editing_tpu_torch.engine import invert as TI
from diffusion_image_editing_tpu_torch.guidance import attr_functions as TA
from diffusion_image_editing_tpu_torch.guidance import create_attr_func_registry

# engine/__init__ re-exports the function `edit` under the submodule's name
JE = importlib.import_module("diffusion_image_editing_tpu.engine.edit")

ALG = dict(rtol=1e-4, atol=5e-5)
GRAD = dict(rtol=1e-4, atol=5e-5)
STEPS, B, C, H = 8, 2, 4, 6
RNG = np.random.default_rng(0)
MIX = (RNG.standard_normal((C, C)) / 2).astype(np.float32)
TO_RGB = RNG.standard_normal((C, 3)).astype(np.float32)


def _t_col(t, ndim, lib):
    t = lib.asarray(t, dtype=lib.float32) if lib is jnp else torch.as_tensor(
        np.asarray(t), dtype=torch.float32)
    return t.reshape((-1,) + (1,) * (ndim - 1)) if t.ndim == 1 else t


def j_eps(params, x, t):
    return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x, params)) * (1 + _t_col(t, 4, jnp) / 1000)


def t_eps(x, t):
    mix = torch.from_numpy(MIX)
    return torch.tanh(torch.einsum("bchw,cd->bdhw", x, mix)) * (1 + _t_col(t, 4, torch) / 1000)


def j_decode(params, z):
    return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", z, params))


def t_decode(z):
    return torch.tanh(torch.einsum("bchw,cd->bdhw", z, torch.from_numpy(TO_RGB)))


J_EPS = JD.EpsClosure(j_eps, jnp.asarray(MIX))
J_DEC = JD.DecodeClosure(j_decode, jnp.asarray(TO_RGB), 1.0)


def j_eps_feat(params, x, t, encoder_features=None, return_encoder_features=False):
    """`j_eps` split at its channel mix, the "encoder", for encoder propagation."""
    feats = jnp.einsum("bhwc,cd->bhwd", x, params) if encoder_features is None \
        else encoder_features
    eps = jnp.tanh(feats) * (1 + _t_col(t, 4, jnp) / 1000)
    return (eps, feats) if return_encoder_features else eps


def t_eps_feat(x, t, encoder_features=None, return_encoder_features=False):
    feats = torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(MIX)) \
        if encoder_features is None else encoder_features
    eps = torch.tanh(feats) * (1 + _t_col(t, 4, torch) / 1000)
    return (eps, feats) if return_encoder_features else eps


J_EPS_FEAT = JD.EpsFeatClosure(j_eps_feat, jnp.asarray(MIX))
T_EPS_FEAT = TD.EpsFeatClosure(t_eps_feat)


def nchw(a):
    a = np.asarray(a)
    return np.ascontiguousarray(
        a.transpose(0, 3, 1, 2) if a.ndim == 4 else a.transpose(0, 1, 4, 2, 3))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), nchw(j), **tol)


@pytest.fixture(scope="module")
def traj():
    """x0, the JAX-drawn forward trajectory and the noise it used."""
    sched = j_schedule("sd", STEPS)
    x0 = RNG.standard_normal((B, H, H, C)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    xts = JI.sample_xts(sched, jnp.asarray(x0), key)
    noise = jax.random.normal(key, (STEPS, B, H, H, C), jnp.float32)
    return sched, t_schedule("sd", STEPS, device="cpu"), x0, xts, noise


def test_sample_xts_with_explicit_noise(traj):
    js, ts, x0, xts, noise = traj
    out = TI.sample_xts(ts, torch.from_numpy(nchw(x0)), noise=torch.from_numpy(nchw(noise)))
    _close(out, xts, ALG)


@pytest.mark.parametrize("start,chunk", [(0, 10), (0, 3), (2, 3), (5, 1)])
def test_ddpm_invert_batched_matches_jax(traj, start, chunk):
    js, ts, x0, xts, _ = traj
    ref = JI.ddpm_invert_batched(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts, chunk=chunk,
                                 start=start)
    out = TI.ddpm_invert_batched(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                                 xts=torch.from_numpy(nchw(xts)), chunk=chunk, start=start)
    _close(out.xt, ref.xt, ALG)
    _close(out.zs, ref.zs, ALG)
    _close(out.xts, ref.xts, ALG)
    assert float(out.zs[:start].abs().sum()) == 0.0 and float(out.zs[-1].abs().sum()) == 0.0


def test_ddpm_invert_sequential_matches_jax(traj):
    js, ts, x0, xts, _ = traj
    ref = JI.ddpm_invert(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts)
    out = TI.ddpm_invert(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                         xts=torch.from_numpy(nchw(xts)))
    _close(out.zs, ref.zs, ALG)
    _close(out.xts, ref.xts, ALG)
    batched = TI.ddpm_invert_batched(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                                     xts=torch.from_numpy(nchw(xts)), chunk=4)
    torch.testing.assert_close(batched.zs, out.zs, **ALG)


def test_ddpm_invert_eta0_forward_loop(traj):
    js, ts, x0, _, _ = traj
    ref = JI.ddpm_invert(js, J_EPS, jnp.asarray(x0), eta=0.0)
    out = TI.ddpm_invert_batched(ts, t_eps, torch.from_numpy(nchw(x0)), eta=0.0)
    assert out.zs is None and out.xts is None
    _close(out.xt, ref.xt, ALG)


def test_inversion_input_checks(traj):
    _, ts, x0, _, _ = traj
    x = torch.from_numpy(nchw(x0))
    with pytest.raises(ValueError):
        TI.ddpm_invert_batched(ts, t_eps, x, start=STEPS)
    with pytest.raises(ValueError):
        TI.ddpm_invert_batched(ts, t_eps, x, chunk=0)
    with pytest.raises(ValueError):
        TI.sample_xts(ts, x, noise=torch.zeros(1))


@pytest.mark.parametrize("invert", ["ddpm_invert", "ddpm_invert_batched"])
def test_inversion_without_noise_raises_as_jax(traj, invert):
    """eta > 0 with no generator, noise or xts: no silent draw from torch's
    global generator; JAX raises for want of a key."""
    js, ts, x0, _, _ = traj
    with pytest.raises(ValueError, match="requires"):
        getattr(JI, invert)(js, J_EPS, jnp.asarray(x0), eta=1.0)
    with pytest.raises(ValueError, match="requires"):
        getattr(TI, invert)(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0)


ATTR = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)


@pytest.mark.parametrize("rule", ["ddim", "ddpm"])
def test_edit_split_matches_jax(traj, rule):
    """Guided edit over the last STEPS - 2 steps; ddpm with eta 1 and noise
    maps (the t_skip flow), ddim with eta 0."""
    js, ts, x0, xts, _ = traj
    inv = JI.ddpm_invert_batched(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts)
    eta, zs = (1.0, inv.zs[2:]) if rule == "ddpm" else (0.0, None)
    x_start = inv.xts[2]
    ref = JE.edit_split(js, J_EPS, x_start, eta=eta, zs=zs,
                        attr_func=JA.SingleColorAttrFunc(**ATTR), decode_fn=J_DEC,
                        step_rule=rule, collect=True)
    out = TE.edit_split(ts, t_eps, torch.from_numpy(nchw(x_start)), eta=eta,
                        zs=None if zs is None else torch.from_numpy(nchw(zs)),
                        attr_func=TA.SingleColorAttrFunc(**ATTR), decode_fn=t_decode,
                        step_rule=rule, collect=True)
    _close(out.x0, ref.x0, GRAD)
    _close(out.xts, ref.xts, GRAD)
    _close(out.model_outputs, ref.model_outputs, GRAD)
    _close(out.pred_original_samples, ref.pred_original_samples, GRAD)
    assert out.xts.shape[0] == (STEPS - 2 if rule == "ddpm" else STEPS)


# name -> (attr kwargs, step index, with mask, with x0_ref, class)
NUDGES = {
    "in_window": (dict(ATTR), 3, False, False, "SingleColorAttrFunc"),
    "out_of_window": (dict(ATTR, t1=4), 3, False, False, "SingleColorAttrFunc"),
    "strided_off": (dict(ATTR, stride=2), 3, False, False, "SingleColorAttrFunc"),
    "strided_on": (dict(ATTR, stride=2), 4, False, False, "SingleColorAttrFunc"),
    "nudge_zt": (dict(ATTR, nudge_zt=True), 1, False, False, "SingleColorAttrFunc"),
    "mask_grad": (dict(ATTR, mask_attr_grad=True, use_mask=True), 1, True, False,
                  "SingleColorAttrFunc"),
    "mask_pred_x0_l2": (dict(ATTR, mask_pred_original_sample=True, use_mask=True,
                             metric="l2", lambda_=0.3), 1, True, True, "SingleColorAttrFunc"),
    "multicolor": (dict(loss_scale=5.0, t1=0, t2=STEPS, r_target=0.2, g_target=0.5,
                        b_target=0.8), 2, False, False, "MultiColorAttrFunc"),
}


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("case", sorted(NUDGES))
def test_attr_nudges_match_jax(traj, case, batch):
    """`apply` (batch 1) and `apply_batched` (batch 2, per-sample gradients)."""
    js, ts, *_ = traj
    kw, idx, with_mask, with_ref, cls = NUDGES[case]
    rng = np.random.default_rng(len(case) + batch)
    x, z, eps = (rng.standard_normal((batch, H, H, C)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(batch, H, H, 1)) > 0.5).astype(np.float32) if with_mask else None
    img_mask = mask[..., :1].repeat(3, -1) if with_mask else None
    ref_img = rng.uniform(-1, 1, (batch, H, H, 3)).astype(np.float32) if with_ref else None
    t = int(js.timesteps[idx])
    # the guidance mask is used both on the latent (mask_attr_grad) and on the
    # decoded image (mask_pred_original_sample); the cases use one at a time
    jmask = img_mask if kw.get("mask_pred_original_sample") else mask
    if jmask is not None and not kw.get("mask_pred_original_sample"):
        jmask = np.repeat(mask, C, axis=-1)
    jx, jz = getattr(JA, cls)(**kw).apply_batched(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(eps), jnp.int32(t), jnp.int32(idx), js,
        J_DEC, mask=None if jmask is None else jnp.asarray(jmask),
        x0=None if ref_img is None else jnp.asarray(ref_img))
    tx, tz = getattr(TA, cls)(**kw).apply_batched(
        torch.from_numpy(nchw(x)), torch.from_numpy(nchw(z)), torch.from_numpy(nchw(eps)), t,
        idx, ts, t_decode, mask=None if jmask is None else torch.from_numpy(nchw(jmask)),
        x0=None if ref_img is None else torch.from_numpy(nchw(ref_img)))
    _close(tx, jx, GRAD)
    _close(tz, jz, GRAD)
    moved = not np.allclose(np.asarray(jx), x)
    assert moved == (case not in ("out_of_window", "strided_off"))


def test_cfg_closure_matches_jax():
    """[uncond; cond] as one batched-2 call, per-sample t tiled for the pair."""
    rng = np.random.default_rng(9)
    text = rng.standard_normal((2, 5, C)).astype(np.float32)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)

    def j_unet(params, lat, t, ctx):
        return j_eps(params, lat, t) + jnp.mean(ctx, axis=(1, 2))[:, None, None, None]

    class TUnet(torch.nn.Module):
        def forward(self, lat, t, ctx):
            return t_eps(lat, t) + ctx.mean(dim=(1, 2))[:, None, None, None]

    for t in (np.int32(301), np.array([801, 41], np.int32)):
        ref = JD.CfgEpsClosure(j_unet, jnp.asarray(MIX), jnp.asarray(text), 3.5)(
            jnp.asarray(x), jnp.asarray(t))
        out = TD.CfgEpsClosure(TUnet(), torch.from_numpy(text), 3.5)(
            torch.from_numpy(nchw(x)), t)
        _close(out, ref, ALG)


def test_registry_builds_ported_strategies():
    """The JAX registry's order and names; NetAttrFunc and ClassifierAttrFunc
    without their network callables build, as in JAX, and their losses say
    what is missing."""
    reg = create_attr_func_registry()
    assert reg.get_attribute_functions() == ["SingleColorAttrFunc", "MultiColorAttrFunc",
                                             "NetAttrFunc", "ClassifierAttrFunc",
                                             "AnyGANAttrFunc"]
    af = reg.get("SingleColorAttrFunc", {"target": 0.3, "color_idx": 2})
    assert isinstance(af, TA.SingleColorAttrFunc) and af.target == 0.3
    net = reg.get("NetAttrFunc")
    assert isinstance(net, TA.NetAttrFunc) and net.idx_for_class == (17,)
    with pytest.raises(ValueError, match="seg_apply_fn"):
        net.loss(torch.zeros(1, 3, 8, 8))
    clf = reg.get("ClassifierAttrFunc")
    assert isinstance(clf, TA.ClassifierAttrFunc) and reg.get("AnyGANAttrFunc") == clf
    with pytest.raises(ValueError, match="clf_apply_fn"):
        clf.loss(torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="No strategy"):
        reg.get("nope")


@pytest.mark.parametrize("refine", [0, 2])
def test_ddim_invert_matches_jax(traj, refine):
    js, ts, x0, _, _ = traj
    ref = JI.ddim_invert(js, J_EPS, jnp.asarray(x0), refine_iters=refine)
    split = JI.ddim_invert_split(js, J_EPS, jnp.asarray(x0), refine_iters=refine)
    out = TI.ddim_invert(ts, t_eps, torch.from_numpy(nchw(x0)), refine_iters=refine)
    _close(out, ref, ALG)
    _close(out, split, ALG)
    part = TI.ddim_invert(ts, t_eps, torch.from_numpy(nchw(x0)), num_steps=3)
    _close(part, JI.ddim_invert(js, J_EPS, jnp.asarray(x0), num_steps=3), ALG)


def test_refined_ddim_inversion_is_closer_to_exact(traj):
    """With refinement, one DDIM step from the inverted x_T lands nearer
    the x_{t-1} it came from (the fixed point of `next_step`)."""
    _, ts, x0, _, _ = traj
    x = torch.from_numpy(nchw(x0))
    t = int(ts.timesteps[-1])
    errs = []
    for refine in (0, 3):
        xt = TI.ddim_invert(ts, t_eps, x, num_steps=1, refine_iters=refine)
        back, _ = TS.ddim_step(ts, xt, t_eps(xt, t), t)
        errs.append((back - x).abs().max().item())
    assert errs[1] < 0.1 * errs[0], errs


@pytest.mark.parametrize("start", [0, 3])
def test_ddpm_invert_sequential_start_matches_jax_split(traj, start):
    js, ts, x0, xts, _ = traj
    ref = JI.ddpm_invert_split(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts, start=start)
    out = TI.ddpm_invert(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                         xts=torch.from_numpy(nchw(xts)), start=start)
    _close(out.xt, ref.xt, ALG)
    _close(out.zs, ref.zs, ALG)
    _close(out.xts, ref.xts, ALG)
    batched = TI.ddpm_invert_batched(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                                     xts=torch.from_numpy(nchw(xts)), start=start, chunk=3)
    torch.testing.assert_close(batched.zs, out.zs, **ALG)
    torch.testing.assert_close(batched.xts, out.xts, **ALG)
    with pytest.raises(ValueError):
        TI.ddpm_invert(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                       xts=torch.from_numpy(nchw(xts)), start=STEPS)


@pytest.mark.parametrize("t_skip,collect", [(0, True), (3, False)])
def test_ddpm_sample_matches_jax(traj, t_skip, collect):
    js, ts, x0, xts, _ = traj
    inv = JI.ddpm_invert(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts)
    ref = JI.ddpm_sample(js, J_EPS, inv.zs, inv.xts, t_skip=t_skip, collect=collect)
    out = TI.ddpm_sample(ts, t_eps, torch.from_numpy(nchw(inv.zs)),
                         torch.from_numpy(nchw(inv.xts)), t_skip=t_skip, collect=collect)
    if collect:
        _close(out[0], ref[0], ALG)
        _close(out[1], ref[1], ALG)
    else:
        _close(out, ref, ALG)


def test_invert_then_sample_reproduces_the_trajectory(traj):
    """eta 1: re-generating from the extracted maps walks the inverted
    trajectory at every step but the last (zs[-1] is zeroed)."""
    _, ts, x0, xts, _ = traj
    inv = TI.ddpm_invert(ts, t_eps, torch.from_numpy(nchw(x0)), eta=1.0,
                         xts=torch.from_numpy(nchw(xts)))
    _, path = TI.ddpm_sample(ts, t_eps, inv.zs, inv.xts, t_skip=0, collect=True)
    torch.testing.assert_close(path[:-1], inv.xts[1:-1], **ALG)
    assert (path[-1] - inv.xts[-1]).abs().max() > 1e-3


GEN_CASES = {"eta0": (0.0, False, None), "eta1_zs": (1.0, True, None),
             "truncated": (1.0, True, 3), "eta0_num_steps": (0.0, False, 5)}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_jax(traj, case):
    js, ts, *_ = traj
    eta, with_zs, num_steps = GEN_CASES[case]
    rng = np.random.default_rng(11)
    xt = rng.standard_normal((B, H, H, C)).astype(np.float32)
    zs = rng.standard_normal((STEPS, B, H, H, C)).astype(np.float32) if with_zs else None
    ref = JD.generate(js, J_EPS, jnp.asarray(xt), eta=eta,
                      zs=None if zs is None else jnp.asarray(zs), num_steps=num_steps,
                      collect=True)
    out = TD.generate(ts, t_eps, torch.from_numpy(nchw(xt)), eta=eta,
                      zs=None if zs is None else torch.from_numpy(nchw(zs)),
                      num_steps=num_steps, collect=True)
    for name in ("x0", "xts", "model_outputs", "pred_original_samples"):
        _close(getattr(out, name), getattr(ref, name), ALG)
    assert out.xts.shape[0] == (num_steps or STEPS)


def test_generate_step_rule_and_refusals(traj):
    js, ts, *_ = traj
    rng = np.random.default_rng(12)
    xt = rng.standard_normal((B, H, H, C)).astype(np.float32)
    zs = rng.standard_normal((4, B, H, H, C)).astype(np.float32)
    ref = JD.generate(js, J_EPS, jnp.asarray(xt), eta=1.0, zs=jnp.asarray(zs),
                      step_rule="ddpm")
    out = TD.generate(ts, t_eps, torch.from_numpy(nchw(xt)), eta=1.0,
                      zs=torch.from_numpy(nchw(zs)), step_rule="ddpm")
    _close(out.x0, ref.x0, ALG)
    assert out.xts is None
    with pytest.raises(ValueError):
        TD.generate(ts, t_eps, torch.from_numpy(nchw(xt)), eta=1.0)
    # encoder_reuse > 1 needs a feature-capable eps_fn, as in JAX; with one
    # it runs and agrees with JAX's loop, and k = 1 through it is the plain loop.
    with pytest.raises(ValueError, match="feature-capable"):
        TD.generate(ts, t_eps, torch.from_numpy(nchw(xt)), encoder_reuse=2)
    x = torch.from_numpy(nchw(xt))
    ref = JD.generate(js, J_EPS_FEAT, jnp.asarray(xt), encoder_reuse=2, collect=True)
    out = TD.generate(ts, T_EPS_FEAT, x, encoder_reuse=2, collect=True)
    _close(out.model_outputs, ref.model_outputs, ALG)
    _close(out.x0, ref.x0, ALG)
    plain = TD.generate(ts, t_eps, x, collect=True)
    k1 = TD.generate(ts, T_EPS_FEAT, x, encoder_reuse=1, collect=True)
    torch.testing.assert_close(k1.xts, plain.xts, rtol=0, atol=0)
    assert not torch.equal(out.x0, plain.x0)


@pytest.mark.parametrize("rule", ["ddim", "ddpm"])
def test_edit_matches_jax_and_the_split_loop(traj, rule):
    """`edit` (the pipeline's fused mode) against the JAX scan, and bit-equal
    to `edit_split` on the same inputs."""
    js, ts, x0, xts, _ = traj
    inv = JI.ddpm_invert_batched(js, J_EPS, jnp.asarray(x0), eta=1.0, xts=xts)
    eta, zs = (1.0, inv.zs[2:]) if rule == "ddpm" else (0.0, None)
    x_start = inv.xts[2]
    jkw = dict(eta=eta, zs=zs, attr_func=JA.SingleColorAttrFunc(**ATTR), decode_fn=J_DEC,
               step_rule=rule, collect=True)
    ref = JE.edit(js, J_EPS, x_start, **jkw)
    kw = dict(eta=eta, zs=None if zs is None else torch.from_numpy(nchw(zs)),
              attr_func=TA.SingleColorAttrFunc(**ATTR), decode_fn=t_decode, step_rule=rule,
              collect=True)
    out = TE.edit(ts, t_eps, torch.from_numpy(nchw(x_start)), **kw)
    split = TE.edit_split(ts, t_eps, torch.from_numpy(nchw(x_start)), **kw)
    for name in ("x0", "xts", "model_outputs", "pred_original_samples"):
        _close(getattr(out, name), getattr(ref, name), GRAD)
        torch.testing.assert_close(getattr(out, name), getattr(split, name), rtol=0, atol=0)
    with pytest.raises(ValueError, match="feature-capable"):
        TE.edit(ts, t_eps, torch.from_numpy(nchw(x_start)), encoder_reuse=2)
    # Encoder propagation at k = 3 against JAX's scan; k = 1 through the
    # feature closure is bit-equal to the plain loop.
    ref3 = JE.edit(js, J_EPS_FEAT, x_start, encoder_reuse=3, **{**jkw, "collect": False})
    out3 = TE.edit(ts, T_EPS_FEAT, torch.from_numpy(nchw(x_start)), encoder_reuse=3,
                   **{**kw, "collect": False})
    _close(out3.x0, ref3.x0, GRAD)
    k1 = TE.edit(ts, T_EPS_FEAT, torch.from_numpy(nchw(x_start)), encoder_reuse=1, **kw)
    torch.testing.assert_close(k1.xts, out.xts, rtol=0, atol=0)
