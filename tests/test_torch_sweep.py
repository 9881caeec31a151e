"""The port's batched sweeps against the JAX package, f32 on the CPU:
`AttrFunc.apply_batched` with swept leaves, `guided_edit_sweep` and
`seed_sweep_generate` (parallel/sweep.py) on the TINY SD models.

Tolerances (latents of magnitude up to about 20 from the random TINY UNet):
* one swept nudge against JAX's `apply_batched`: rtol 1e-3, atol 1e-4
  (tests/test_torch_remat.py's nudges); the chunks 1, 2 and 4 of the port
  against each other rtol 1e-5, atol 1e-7 (the decoder's convolutions at
  another batch may sum in another order); a sample outside its window or
  at scale 0 keeps its latent to the bit;
* 3-step sweeps and generations against JAX, and a sweep against its grid
  points edited one at a time: atol 2e-4 (f32 sums in another order over
  three UNet calls: the readings were 1.4e-5 to 2.8e-5); the grid's points
  differ by about 2e-2, a hundred times that, so a point swapped, dropped or
  given another scale would show;
* a seed sweep against the same seeds generated one at a time: atol 2e-4
  too (the same draws; the CPU's convolutions may pick another algorithm
  at another batch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.engine.denoise import generate as j_generate
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.parallel import sweep as JS
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.engine import edit_split, generate
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.parallel import (
    guided_edit_sweep, seed_sweep_generate, sweep_attr_func)
from diffusion_image_editing_tpu_torch.parallel.sweep import seed_draws
from diffusion_image_editing_tpu_torch.pipeline import SD
from tests.torch_port_helpers import nchw, tiny_unet_params, tiny_vae_params

NUDGE = dict(rtol=1e-3, atol=1e-4)
CHUNK = dict(rtol=1e-5, atol=1e-7)
EDIT = dict(rtol=0, atol=2e-4)
STEPS = 3
GRID = np.array([0.0, 10.0, 20.0], np.float32)
COLOR = dict(target=0.9, color_idx=0, t1=0, t2=STEPS)


@pytest.fixture(scope="module")
def sd():
    """(JAX SD, port SD, [uncond; cond] embedding) with the same TINY weights."""
    unet, uparams = tiny_unet_params()
    vae, vparams = tiny_vae_params()
    tu = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(uparams, "unet_cond"))
    tv = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
    tv.load_state_dict(TM.state_dict_from_jax(vparams, "vae"))
    jw = JSD(unet, jax.tree.map(jnp.asarray, uparams), j_schedule("sd", STEPS), vae,
             jax.tree.map(jnp.asarray, vparams))
    tw = SD(tu, tv, schedule_for_model("sd", STEPS), device="cpu")
    emb = np.random.default_rng(0).standard_normal((2, 7, 32)).astype(np.float32)
    return jw, tw, emb


def _t(a):
    return torch.from_numpy(nchw(a))


# Four samples: scales 0, 5, 10 and 20; at step 1 the third is before its
# window (t1 = 2) and the fourth after it (t2 = 1); lambda_ weighs the l2
# background term of each.
SWEPT = dict(loss_scale=[0.0, 5.0, 10.0, 20.0], t1=[0, 0, 2, 0], t2=[STEPS, STEPS, STEPS, 1],
             lambda_=[0.5, 0.01, 2.0, 1.0])


SWEPT_KW = dict(target=0.9, color_idx=0, use_mask=True, mask_pred_original_sample=True,
                metric="l2")
SWEPT_IDX = 1


@pytest.fixture(scope="module")
def swept_case(sd):
    """Inputs of one swept nudge at step SWEPT_IDX and JAX's result. JAX's
    `vjp_chunk` only batches its `lax.map` (each sample's VJP is its own), so
    one JAX run serves the port's chunks 1, 2 and 4."""
    jw, tw, _ = sd
    rng = np.random.default_rng(3)
    x, eps = (rng.standard_normal((4, 16, 16, 4)).astype(np.float32) for _ in range(2))
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 8:24, 4:20] = 1.0
    ref = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    t = int(tw.schedule.timesteps[SWEPT_IDX])
    jaf = JS.sweep_attr_func(JSingleColor(**SWEPT_KW), **SWEPT)
    jx, _ = jaf.apply_batched(jnp.asarray(x), None, jnp.asarray(eps), jnp.int32(t),
                              jnp.int32(SWEPT_IDX), jw.schedule, jw.decode_fn(),
                              mask=jnp.asarray(mask), x0=jnp.asarray(ref))
    return x, eps, mask, ref, t, np.asarray(jx)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_swept_apply_batched_matches_jax(sd, swept_case, chunk):
    _, tw, _ = sd
    x, eps, mask, ref, t, jx = swept_case
    kw = dict(SWEPT_KW, vjp_chunk=chunk)
    idx = SWEPT_IDX
    af = sweep_attr_func(SingleColorAttrFunc(**kw), **SWEPT)
    assert af.swept_fields(4) == ("loss_scale", "t1", "t2", "lambda_")
    assert af.loss_scale.dtype == torch.float32 and af.t1.dtype == torch.int64
    got, _ = af.apply_batched(_t(x), None, _t(eps), t, idx, tw.schedule, tw.decode_fn(),
                              mask=_t(mask), x0=_t(ref))
    np.testing.assert_allclose(got.numpy(), nchw(jx), **NUDGE)
    # Scale 0 and the two samples outside their windows keep their latents.
    assert torch.equal(got[[0, 2, 3]], _t(x)[[0, 2, 3]])
    assert (got[1] - _t(x)[1]).abs().max() > 1e-3
    # Each sample as a scalar AttrFunc of its own, one at a time.
    for i in range(4):
        one = dataclasses.replace(SingleColorAttrFunc(**kw),
                                  **{f: v[i] for f, v in SWEPT.items()})
        want, _ = one.apply_batched(_t(x)[i:i + 1], None, _t(eps)[i:i + 1], t, idx,
                                    tw.schedule, tw.decode_fn(), mask=_t(mask),
                                    x0=_t(ref)[i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, **CHUNK)
    with pytest.raises(ValueError, match="apply_batched"):
        af.apply(_t(x), None, _t(eps), t, idx, tw.schedule, tw.decode_fn())


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_guided_edit_sweep_matches_jax_and_single_edits(sd, eta):
    """A loss-scale grid of 3 on one batch-1 latent (eta 1: one zs shared by
    every point) against JAX's sweep and against 3 separate port edits;
    point 0 (scale 0) is the unguided edit."""
    jw, tw, emb = sd
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    zs = rng.standard_normal((STEPS, 1, 16, 16, 4)).astype(np.float32) if eta else None
    jaf = JS.sweep_attr_func(JSingleColor(**COLOR), loss_scale=GRID)
    want = np.asarray(JS.guided_edit_sweep(
        jw.schedule, jw.eps_fn(jnp.asarray(emb)), jnp.asarray(xt), jaf, eta=eta,
        zs=None if zs is None else jnp.asarray(zs), decode_fn=jw.decode_fn()))
    tzs = None if zs is None else torch.from_numpy(np.ascontiguousarray(
        zs.transpose(0, 1, 4, 2, 3)))
    eps_fn = tw.eps_fn(torch.from_numpy(emb))
    af = sweep_attr_func(SingleColorAttrFunc(**COLOR), loss_scale=GRID)
    got = guided_edit_sweep(tw.schedule, eps_fn, _t(xt), af, eta=eta, zs=tzs,
                            decode_fn=tw.decode_fn())
    assert got.shape == (3, 1, 4, 16, 16)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 1, 4, 2, 3), **EDIT)
    for g, scale in enumerate(GRID):
        one = edit_split(tw.schedule, eps_fn, _t(xt), eta=eta, zs=tzs,
                         attr_func=SingleColorAttrFunc(**COLOR, loss_scale=float(scale)),
                         decode_fn=tw.decode_fn()).x0
        torch.testing.assert_close(got[g], one, **EDIT)
    unguided = edit_split(tw.schedule, eps_fn, _t(xt), eta=eta, zs=tzs).x0
    torch.testing.assert_close(got[0], unguided, **EDIT)
    assert (got[2] - got[0]).abs().max() > 100 * EDIT["atol"]


def test_seed_sweep_generate_matches_per_seed_and_jax(sd, monkeypatch):
    jw, tw, emb = sd
    seeds, shape = [3, 7], (1, 4, 16, 16)
    eps_fn = tw.eps_fn(torch.from_numpy(emb))
    got = seed_sweep_generate(tw.schedule, eps_fn, shape, seeds, eta=1.0, device="cpu")
    assert got.shape == (2,) + shape
    draws = [seed_draws(seed, shape, STEPS, 1.0, torch.device("cpu")) for seed in seeds]
    for i, (xt, zs) in enumerate(draws):
        one = generate(tw.schedule, eps_fn, xt, eta=1.0, zs=zs).x0
        torch.testing.assert_close(got[i], one, **EDIT)
    # JAX's generate fed the port's draws, both seeds as one batch (seeds are
    # not compared across frameworks).
    xt = torch.cat([d[0] for d in draws]).numpy()
    zs = torch.cat([d[1] for d in draws], dim=1).numpy()
    jx = j_generate(jw.schedule, jw.eps_fn(jnp.asarray(emb)),
                    jnp.asarray(xt.transpose(0, 2, 3, 1)), eta=1.0,
                    zs=jnp.asarray(zs.transpose(0, 1, 3, 4, 2))).x0
    np.testing.assert_allclose(got.reshape(xt.shape).numpy(), nchw(np.asarray(jx)), **EDIT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # CUDA unless asked
        seed_sweep_generate(tw.schedule, eps_fn, shape, seeds)
