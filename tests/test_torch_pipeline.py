"""The port's entry points: where they run, what they refuse, and their
defaults and options against the JAX package's `EditPipeline`.

The masked edit runs the port's and the JAX package's `edit_image` on the
same tiny weights, latent, text embedding and mask, f32 on both sides,
within atol 1e-2 (as tests/test_torch_slice.py: the L1 colour loss has a
sign gradient, so a pixel within rounding of the target can flip its
contribution between the two frameworks).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu_torch.core import resolve_device, schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models import (
    TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition, state_dict_from_jax)
from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline
from tests.torch_port_helpers import FixedTextSD, nchw, tiny_unet_params, tiny_vae_params

STEPS = 4
EDIT = dict(rtol=0, atol=1e-2)


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    sd = FixedTextSD(UNet2DCondition(TINY_SD_UNET, device="cpu"),
                     AutoencoderKL(TINY_VAE, device="cpu"), schedule_for_model("sd", STEPS),
                     text_emb=torch.zeros(2, 7, 32), device="cpu")
    return EditPipeline(sd)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        SD(UNet2DCondition(TINY_SD_UNET, device="cpu"), AutoencoderKL(TINY_VAE, device="cpu"),
           schedule_for_model("sd", 4))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrapper_places_everything_on_its_device(pipe):
    sd = pipe.diffusion_wrapper
    assert sd.device.type == "cpu" and sd.schedule.device.type == "cpu"
    assert sd.prep_text(None).shape == (2, 7, 32)  # the caller's fixed embedding
    plain = SD(sd.unet, sd.vae, sd.schedule, device="cpu")
    assert plain.prep_text(None) is None  # as JAX: no prompt, an unconditional run
    with pytest.raises(NotImplementedError):
        plain.prep_text(np.zeros(77, np.int32))


@pytest.mark.parametrize("kwargs", [dict(), dict(inversion_method="ddim"), dict(mode="split"),
                                    dict(inversion_method="ddpm", eta=1.0, mode="split"),
                                    dict(classes=[17], inversion_method="ddpm", eta=1.0)])
def test_unported_options_raise(pipe, kwargs):
    """With no arguments the JAX defaults ask for DDIM inversion, not ported yet."""
    with pytest.raises(NotImplementedError):
        pipe.prepare_real_image_edit(torch.zeros(1, 3, 32, 32), **kwargs)


@pytest.mark.parametrize("method,names", [
    ("prepare_real_image_edit",
     ("eta", "inversion_method", "mode", "t_skip", "cfg_scale", "classes", "prompt_ids")),
    # edit_image's mode stays "split": JAX's "fused" scan is not ported.
    ("edit_image", ("eta", "inversion_method", "t_skip", "cfg_scale", "prompt_ids", "mask",
                    "resynthesize", "collect")),
])
def test_defaults_are_the_jax_package_s(method, names):
    port = inspect.signature(getattr(EditPipeline, method)).parameters
    ref = inspect.signature(getattr(JEditPipeline, method)).parameters
    for name in names:
        assert port[name].default == ref[name].default, (method, name)


def test_ddim_inversion_refuses_eta(pipe):
    with pytest.raises(ValueError, match="not possible"):
        pipe.prepare_real_image_edit(torch.zeros(1, 3, 32, 32), eta=1.0)


def test_edit_image_checks_its_inputs(pipe):
    xt = torch.zeros(1, 4, 16, 16)
    attr = SingleColorAttrFunc()
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=None, attr_func=attr)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=0.0, attr_func=None)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=torch.zeros(4, 1, 4, 16, 16), xts=torch.zeros(5),
                        attr_func=attr)
    with pytest.raises(NotImplementedError):
        pipe.edit_image(xt, attr_func=attr, mode="fused")
    with pytest.raises(NotImplementedError):
        pipe.edit_image(xt, mask=torch.ones(1, 4, 16, 16), resynthesize=True)
    with pytest.raises(NotImplementedError):
        EditPipeline(pipe.diffusion_wrapper, segmentation_fn=lambda img: img)


def test_ddim_edit_runs_without_noise_maps(pipe):
    out = pipe.edit_image(torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(0)),
                          eta=0.0, attr_func=SingleColorAttrFunc(t2=4), collect=False)
    assert out.imgs.shape == (1, 3, 32, 32) and out.model_outputs is None
    assert torch.isfinite(out.imgs).all()


def test_a_mask_alone_is_an_edit(pipe):
    """As JAX's `check_inputs`: no attribute function, but a mask, is taken."""
    out = pipe.edit_image(torch.zeros(1, 4, 16, 16), eta=0.0, mask=torch.ones(1, 4, 16, 16),
                          collect=False)
    assert out.imgs.shape == (1, 3, 32, 32)


def test_t_skip_past_the_trajectory_clamps(pipe):
    """t_skip > num_inference_steps reads the last step, as the inversion's
    start is clamped, instead of indexing past xts."""
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1
    attr = SingleColorAttrFunc(t2=STEPS)
    runs = {}
    for t_skip in (STEPS - 1, STEPS + 3):
        xt, zs, xts, _, _ = pipe.prepare_real_image_edit(
            img, eta=1.0, inversion_method="ddpm", t_skip=t_skip,
            generator=torch.Generator().manual_seed(1))
        runs[t_skip] = pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, attr_func=attr,
                                       inversion_method="ddpm", t_skip=t_skip)
    clamped, last = runs[STEPS + 3], runs[STEPS - 1]
    assert clamped.model_outputs.shape[0] == 1
    torch.testing.assert_close(clamped.imgs, last.imgs, rtol=0, atol=0)


@pytest.fixture(scope="module")
def masked_edits():
    """A DDIM edit (eta 0) of a random latent with the colour gradient masked
    to the left half of the latent, through both packages' `edit_image`."""
    rng = np.random.default_rng(2)
    text = rng.standard_normal((2, 77, 32)).astype(np.float32)
    xt = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    mask = np.zeros((1, 16, 16, 4), np.float32)
    mask[:, :, :8] = 1.0
    attr = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS, use_mask=True,
                mask_attr_grad=True)
    unet, uparams = tiny_unet_params()
    vae, vparams = tiny_vae_params()

    class JFixedTextSD(JSD):
        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    jpipe = JEditPipeline(JFixedTextSD(unet, uparams, j_schedule("sd", STEPS), vae, vparams))
    jout = jpipe.edit_image(jnp.asarray(xt), eta=0.0, mask=jnp.asarray(mask),
                            attr_func=JSingleColor(**attr), mode="split")

    tu = UNet2DCondition(TINY_SD_UNET, device="cpu")
    tu.load_state_dict(state_dict_from_jax(uparams, "unet_cond"))
    tv = AutoencoderKL(TINY_VAE, device="cpu")
    tv.load_state_dict(state_dict_from_jax(vparams, "vae"))
    tpipe = EditPipeline(FixedTextSD(tu, tv, schedule_for_model("sd", STEPS),
                                     text_emb=torch.from_numpy(text), device="cpu"))
    txt, tmask = torch.from_numpy(nchw(xt)), torch.from_numpy(nchw(mask))
    tout = tpipe.edit_image(txt, eta=0.0, mask=tmask, attr_func=SingleColorAttrFunc(**attr))
    unmasked = tpipe.edit_image(txt, eta=0.0, attr_func=SingleColorAttrFunc(
        **dict(attr, use_mask=False, mask_attr_grad=False)))
    return jout, tout, unmasked


def test_masked_edit_matches_jax(masked_edits):
    jout, tout, unmasked = masked_edits
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               np.asarray(jout.pred_original_samples).transpose(0, 1, 4, 2, 3),
                               **EDIT)
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    # The mask reached the guidance: the masked edit differs from the unmasked one.
    assert (tout.imgs - unmasked.imgs).abs().max().item() > 1e-3
