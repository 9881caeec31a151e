"""The whole slice at tiny size: the port's EditPipeline against the JAX
package's, same weights, image, text embedding and trajectory noise.

VAE encode -> edit-friendly DDPM inversion (batched, t_skip 1, 5 steps) ->
4 colour-guided steps, each with a gradient through the VAE decoder ->
decode. The JAX side draws the trajectory noise inside `sample_xts` from a
key; the test rebuilds that draw from the same key and hands it to the port.

Tolerances (f32 on both sides): the trajectory and noise maps rtol 1e-4,
atol 1e-3 (z divides by sigma, see test_torch_engine.py, and reaches |z| ~
100 with random weights); the guided latents and the image atol 1e-2: the
L1 colour loss has a sign gradient, so a pixel whose decoded value sits
within rounding of the target can flip its contribution between the two
frameworks, and four guided steps carry that forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models import (
    TINY_SD_UNET,
    TINY_VAE,
    AutoencoderKL,
    UNet2DCondition,
    state_dict_from_jax,
)
from diffusion_image_editing_tpu_torch.pipeline import EditPipeline
from tests.torch_port_helpers import FixedTextSD, nchw, tiny_unet_params, tiny_vae_params

STEPS, T_SKIP = 5, 1
TRAJ = dict(rtol=1e-4, atol=1e-3)
EDIT = dict(rtol=0, atol=1e-2)
ATTR = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)


def nchw5(a):
    return np.asarray(a).transpose(0, 1, 4, 2, 3)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 77, 32)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    unet, uparams = tiny_unet_params()
    vae, vparams = tiny_vae_params()

    class JFixedTextSD(JSD):
        """No CLIP weights here: a fixed [uncond; cond] embedding, as bench.py."""

        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    jpipe = JEditPipeline(JFixedTextSD(unet, uparams, j_schedule("sd", STEPS), vae, vparams))
    jxt, jzs, jxts, _, _ = jpipe.prepare_real_image_edit(
        jnp.asarray(img), eta=1.0, inversion_method="ddpm", mode="batched", t_skip=T_SKIP,
        key=key)
    jout = jpipe.edit_image(jxt, eta=1.0, zs=jzs, xts=jxts, attr_func=JSingleColor(**ATTR),
                            inversion_method="ddpm", t_skip=T_SKIP, mode="split")

    tu = UNet2DCondition(TINY_SD_UNET, device="cpu")
    tu.load_state_dict(state_dict_from_jax(uparams, "unet_cond"))
    tv = AutoencoderKL(TINY_VAE, device="cpu")
    tv.load_state_dict(state_dict_from_jax(vparams, "vae"))
    latent_shape = (1, 16, 16, 4)  # NHWC latent of a 32 px image
    noise = jax.random.normal(key, (STEPS,) + latent_shape, jnp.float32)  # sample_xts' draw
    pipe = EditPipeline(FixedTextSD(tu, tv, schedule_for_model("sd", STEPS),
                                    text_emb=torch.from_numpy(text), device="cpu"))
    txt, tzs, txts, mask, parsing = pipe.prepare_real_image_edit(
        torch.from_numpy(nchw(img)), eta=1.0, inversion_method="ddpm", mode="batched",
        t_skip=T_SKIP, noise=torch.from_numpy(nchw5(noise).copy()))
    assert mask is None and parsing is None
    tout = pipe.edit_image(txt, eta=1.0, zs=tzs, xts=txts, attr_func=SingleColorAttrFunc(**ATTR),
                           inversion_method="ddpm", t_skip=T_SKIP, mode="split")
    unguided = pipe.edit_image(txt, eta=1.0, zs=tzs, xts=txts,
                               attr_func=SingleColorAttrFunc(**dict(ATTR, t1=STEPS)),
                               inversion_method="ddpm", t_skip=T_SKIP, mode="split")
    return (jxts, jzs, jout), (txts, tzs, tout, unguided)


def test_inversion_matches_jax(both):
    (jxts, jzs, _), (txts, tzs, _, _) = both
    np.testing.assert_allclose(txts.numpy(), nchw5(jxts), **TRAJ)
    np.testing.assert_allclose(tzs.numpy(), nchw5(jzs), **TRAJ)
    assert float(tzs[:T_SKIP].abs().sum()) == 0.0  # the skipped prefix is never extracted


def test_guided_edit_matches_jax(both):
    (_, _, jout), (_, _, tout, _) = both
    assert tout.model_outputs.shape[0] == STEPS - T_SKIP
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               nchw5(jout.pred_original_samples), **EDIT)
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    assert torch.isfinite(tout.imgs).all()


def test_guidance_lowers_the_colour_loss(both):
    """Against the same edit with an empty guidance window, the colour
    guidance moves the red channel towards its target."""
    _, (_, _, tout, unguided) = both
    loss = SingleColorAttrFunc(**ATTR).loss
    assert float(loss(tout.imgs)) < float(loss(unguided.imgs))
