"""Encoder propagation in the port (`encoder_features` in both UNets, the
feature closures, `encoder_reuse` in `generate` and `edit_split`) against
the JAX package, weights carried across with `state_dict_from_jax`, inputs
from numpy.

Layout: JAX NHWC, the port NCHW; features are transposed at the boundary.
Tolerances, f32 on both sides: a forward and its features differ by
summation order only (rtol 1e-4, atol 1e-5, as tests/test_torch_models.py);
a 4-step generation rtol 1e-4, atol 1e-4; the colour-guided edit atol 1e-2
(as tests/test_torch_slice.py: the L1 colour loss has a sign gradient that
a pixel within rounding of its target can flip). Within the port, `reuse`
given the same step's features and k = 1 through the feature closure are
bit-equal to the plain forward and loop.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.engine import denoise as JD
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.engine import denoise as TD
from diffusion_image_editing_tpu_torch.engine import edit_split
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from tests.torch_port_helpers import nchw, tiny_unet2d_params, tiny_unet_params, tiny_vae_params

JE = importlib.import_module("diffusion_image_editing_tpu.engine.edit")

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GEN_TOL = dict(rtol=1e-4, atol=1e-4)
EDIT_TOL = dict(rtol=0, atol=1e-2)
STEPS = 4
ATTR = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)


def nchw5(a):
    return np.asarray(a).transpose(0, 1, 4, 2, 3)


@pytest.fixture(scope="module")
def sd_pair():
    ju, params = tiny_unet_params()
    tu = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(params, "unet_cond"))
    return ju, params, tu


@pytest.fixture(scope="module")
def ddpm_pair():
    ju, params = tiny_unet2d_params()
    tu = TM.UNet2D(TM.TINY_UNET2D, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(params, "unet2d"))
    return ju, params, tu


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "sd":
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        return x, (rng.standard_normal((2, 7, 32)).astype(np.float32),)
    return rng.standard_normal((2, 16, 16, 3)).astype(np.float32), ()


@pytest.mark.parametrize("kind", ["sd", "ddpm"])
def test_features_and_reuse_match_jax(request, kind):
    """`full`'s features against JAX's; `reuse` fed JAX's features at
    another timestep against JAX's `reuse`; in the port, `reuse` given the
    same step's features is the full forward bit for bit."""
    ju, params, tu = request.getfixturevalue(f"{kind}_pair")
    x, ctx = _inputs(kind, 1)
    jctx = tuple(jnp.asarray(c) for c in ctx)
    tctx = tuple(torch.from_numpy(c) for c in ctx)
    t, t2 = np.array([700, 300], np.int32), np.int32(650)
    ref, jfeats = jax.jit(lambda *a: ju.apply(*a, return_encoder_features=True))(
        params, jnp.asarray(x), jnp.asarray(t), *jctx)
    jreuse = jax.jit(lambda f, *a: ju.apply(*a, encoder_features=f))(
        jfeats, params, jnp.asarray(x * 0.9), jnp.asarray(t2), *jctx)
    with torch.no_grad():
        out, feats = tu(torch.from_numpy(nchw(x)), t, *tctx, return_encoder_features=True)
        plain = tu(torch.from_numpy(nchw(x)), t, *tctx)
        again = tu(torch.from_numpy(nchw(x)), t, *tctx, encoder_features=feats)
        fed = {"h": torch.from_numpy(nchw(jfeats["h"]).copy()),
               "skips": tuple(torch.from_numpy(nchw(s).copy()) for s in jfeats["skips"])}
        reuse = tu(torch.from_numpy(nchw(x * 0.9)), t2, *tctx, encoder_features=fed)
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)
    assert len(feats["skips"]) == len(jfeats["skips"])
    np.testing.assert_allclose(feats["h"].numpy(), nchw(jfeats["h"]), **FWD_TOL)
    for s, js in zip(feats["skips"], jfeats["skips"]):
        np.testing.assert_allclose(s.numpy(), nchw(js), **FWD_TOL)
    np.testing.assert_allclose(reuse.numpy(), nchw(jreuse), **FWD_TOL)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(again, plain, rtol=0, atol=0)


@pytest.fixture(scope="module")
def sd_loop(sd_pair):
    """CFG feature closures and decoders of both packages on the TINY SD."""
    ju, params, tu = sd_pair
    jv, vparams = tiny_vae_params()
    tv = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
    tv.load_state_dict(TM.state_dict_from_jax(vparams, "vae"))
    rng = np.random.default_rng(2)
    text = rng.standard_normal((2, 7, 32)).astype(np.float32)
    xt = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jeps = JD.CfgEpsFeatClosure(ju.apply, params, jnp.asarray(text), 3.5)
    jdec = JD.DecodeClosure(lambda p, z: jv.apply(p, z, method="decode"), vparams, 0.18215)
    teps = TD.CfgEpsFeatClosure(tu, torch.from_numpy(text), 3.5)
    tdec = TD.DecodeClosure(tv, 0.18215)
    return (jeps, jdec), (teps, tdec), xt


def test_generate_at_k2_matches_jax_and_k1_is_the_plain_loop(sd_loop):
    (jeps, _), (teps, _), xt = sd_loop
    ref = JD.generate(j_schedule("sd", STEPS), jeps, jnp.asarray(xt), encoder_reuse=2,
                      collect=True)
    sched = schedule_for_model("sd", STEPS)
    x = torch.from_numpy(nchw(xt))
    out = TD.generate(sched, teps, x, encoder_reuse=2, collect=True)
    np.testing.assert_allclose(out.model_outputs.numpy(), nchw5(ref.model_outputs), **GEN_TOL)
    np.testing.assert_allclose(out.x0.numpy(), nchw(ref.x0), **GEN_TOL)
    plain = TD.generate(sched, TD.CfgEpsClosure(teps.unet, teps.text_emb, 3.5), x, collect=True)
    k1 = TD.generate(sched, teps, x, encoder_reuse=1, collect=True)
    torch.testing.assert_close(k1.xts, plain.xts, rtol=0, atol=0)
    assert not torch.equal(out.x0, plain.x0)  # the reuse steps approximate


def test_guided_edit_split_at_k2_matches_jax(sd_loop):
    (jeps, jdec), (teps, tdec), xt = sd_loop
    ref = JE.edit_split(j_schedule("sd", STEPS), jeps, jnp.asarray(xt),
                        attr_func=JSingleColor(**ATTR), decode_fn=jdec, encoder_reuse=2,
                        collect=True)
    sched = schedule_for_model("sd", STEPS)
    x = torch.from_numpy(nchw(xt))
    out = edit_split(sched, teps, x, attr_func=SingleColorAttrFunc(**ATTR), decode_fn=tdec,
                     encoder_reuse=2, collect=True)
    np.testing.assert_allclose(out.xts.numpy(), nchw5(ref.xts), **EDIT_TOL)
    np.testing.assert_allclose(out.model_outputs.numpy(), nchw5(ref.model_outputs), **EDIT_TOL)
    unguided = edit_split(sched, teps, x, encoder_reuse=2)
    assert (out.x0 - unguided.x0).abs().max() > 1e-4  # the guidance moved the latent
    with pytest.raises(ValueError, match="feature-capable"):
        edit_split(sched, TD.CfgEpsClosure(teps.unet, teps.text_emb, 3.5), x, encoder_reuse=2)


def test_wrapper_hands_out_the_feature_closures(sd_pair):
    """`eps_fn(features=True)`: the CFG or unconditional feature closure;
    with a mesh it raises, as in the JAX package."""
    import copy

    from diffusion_image_editing_tpu_torch.pipeline import SD

    tsd = SD(sd_pair[2], TM.AutoencoderKL(TM.TINY_VAE, device="cpu"),
             schedule_for_model("sd", STEPS), device="cpu")
    emb = torch.zeros(2, 7, 32)
    assert type(tsd.eps_fn(emb, features=True)) is TD.CfgEpsFeatClosure
    assert type(tsd.eps_fn(None, features=True)) is TD.EpsFeatClosure
    assert type(tsd.eps_fn(emb)) is TD.CfgEpsClosure
    meshed = copy.copy(tsd)
    meshed._mesh = object()
    with pytest.raises(ValueError, match="to_mesh"):
        meshed.eps_fn(emb, features=True)
