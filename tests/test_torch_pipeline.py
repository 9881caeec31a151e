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
    with pytest.raises(ValueError, match="text encoder"):  # prompt ids need CLIP
        plain.prep_text(np.zeros((2, 77), np.int32))


@pytest.mark.parametrize("kwargs", [dict(), dict(inversion_method="ddim"), dict(mode="split"),
                                    dict(inversion_method="ddpm", eta=1.0, mode="split"),
                                    dict(classes=[17], inversion_method="ddpm", eta=1.0),
                                    dict(dilate_mask=True)])
def test_unported_options_raise(pipe, kwargs):
    """Each option of `prepare_real_image_edit` runs to a finite inversion of
    the latent's shape (DDIM by default, as the JAX package). As in the JAX
    package, `classes` without a segmentation model raises ValueError, and
    `dilate_mask` without `classes` makes no mask."""
    img = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)) * 2 - 1
    gen = torch.Generator().manual_seed(1)
    if "classes" in kwargs:
        with pytest.raises(ValueError, match="no segmentation model"):
            pipe.prepare_real_image_edit(img, generator=gen, **kwargs)
        return
    xt, zs, xts, mask, parsing = pipe.prepare_real_image_edit(img, generator=gen, **kwargs)
    assert tuple(xt.shape) == (1, 4, 16, 16) and torch.isfinite(xt).all()
    assert mask is None and parsing is None
    if kwargs.get("inversion_method") == "ddpm":
        assert tuple(zs.shape) == (STEPS, 1, 4, 16, 16) and tuple(xts.shape)[0] == STEPS + 1
        assert torch.isfinite(zs).all() and torch.equal(xts[0], xt)
    else:
        assert zs is None and xts is None


@pytest.mark.parametrize("method,names", [
    ("prepare_real_image_edit",
     ("eta", "inversion_method", "mode", "t_skip", "cfg_scale", "classes", "prompt_ids",
      "refine_iters", "dilate_mask", ("generator", "key"))),
    ("edit_image", ("eta", "inversion_method", "t_skip", "cfg_scale", "prompt_ids", "mask",
                    "resynthesize", "collect", "mode", "x0_ref", "decode_remat",
                    "encoder_reuse", "guidance_codec", ("generator", "key"))),
])
def test_defaults_are_the_jax_package_s(method, names):
    """(port name, JAX name) where the port takes a torch.Generator for a key."""
    port = inspect.signature(getattr(EditPipeline, method)).parameters
    ref = inspect.signature(getattr(JEditPipeline, method)).parameters
    for name in names:
        pname, jname = name if isinstance(name, tuple) else (name, name)
        assert port[pname].default == ref[jname].default, (method, name)


def test_ddim_inversion_refuses_eta(pipe):
    with pytest.raises(ValueError, match="not possible"):
        pipe.prepare_real_image_edit(torch.zeros(1, 3, 32, 32), eta=1.0)


def test_edit_image_checks_its_inputs(pipe):
    xt = torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(3))
    attr = SingleColorAttrFunc(t2=STEPS)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=None, attr_func=attr)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=0.0, attr_func=None)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=torch.zeros(4, 1, 4, 16, 16), xts=torch.zeros(5),
                        attr_func=attr)
    # Both modes run, and run the same loop.
    fused = pipe.edit_image(xt, attr_func=attr, mode="fused")
    split = pipe.edit_image(xt, attr_func=attr, mode="split")
    assert torch.isfinite(fused.imgs).all()
    torch.testing.assert_close(fused.imgs, split.imgs, rtol=0, atol=0)
    # Resynthesis: a mask alone is an edit; the fresh noise changes the image.
    box = torch.zeros(1, 4, 16, 16)
    box[..., 4:12, 4:12] = 1.0
    plain = pipe.edit_image(xt, mask=box, collect=False)
    resyn = pipe.edit_image(xt, mask=box, resynthesize=True, collect=False)
    assert torch.isfinite(resyn.imgs).all()
    assert (resyn.imgs - plain.imgs).abs().max() > 1e-3
    with pytest.raises(ValueError):
        pipe.edit_image(xt, attr_func=attr, mode="scan")
    for kwargs in (dict(decode_remat="blocks"), dict(guidance_codec="proxy"),
                   dict(encoder_reuse=2)):
        with pytest.raises(NotImplementedError, match="item"):
            pipe.edit_image(xt, attr_func=attr, **kwargs)
    # A segmentation function is taken (tests/test_torch_segguide.py runs it).
    seg_fn = lambda img: torch.zeros(32, 32, dtype=torch.long)  # noqa: E731
    assert EditPipeline(pipe.diffusion_wrapper, segmentation_fn=seg_fn).segmentation_fn is seg_fn


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


# ---------------------------------------------------------------------------
# The slice as a user starts it: a checkpoint directory -> factory -> prompt
# -> generate; DDIM prepare -> resynthesized fused edit. Both packages load
# the same TINY directory, f32, and take the same noise.
# ---------------------------------------------------------------------------

PROMPT = "the red cat"


@pytest.fixture(scope="module")
def sd_pair(tmp_path_factory):
    from diffusion_image_editing_tpu.pipeline.factory import create_diffusion_model as j_create
    from diffusion_image_editing_tpu_torch.pipeline import create_diffusion_model
    from tests.torch_port_helpers import write_tiny_sd_dir

    root = str(tmp_path_factory.mktemp("sd"))
    write_tiny_sd_dir(root, "bin", legacy_vae_names=True)
    jsd = j_create("sd", checkpoint_dir=root, num_inference_steps=STEPS, dtype=jnp.float32)
    tsd = create_diffusion_model("sd", checkpoint_dir=root, num_inference_steps=STEPS,
                                 dtype=torch.float32, device="cpu")
    ids = tsd.tokenizer.encode(PROMPT)
    assert ids == jsd.tokenizer.encode(PROMPT)
    return jsd, tsd, np.asarray(ids, np.int32)


def test_prep_text_pairs_a_single_sequence_with_the_empty_prompt(sd_pair):
    jsd, tsd, ids = sd_pair
    emb = tsd.prep_text(ids)
    pair = np.stack([np.asarray(tsd.tokenizer.encode(""), np.int32), ids])
    torch.testing.assert_close(emb, tsd.encode_text_ids(pair), rtol=0, atol=0)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jsd.prep_text(jnp.asarray(ids))),
                               rtol=1e-4, atol=1e-5)
    no_tok = SD(tsd.unet, tsd.vae, tsd.schedule, tsd.text_encoder, None, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        no_tok.prep_text(ids)
    torch.testing.assert_close(no_tok.prep_text(pair), emb, rtol=0, atol=0)


def test_generate_image_split_fused_and_jax(sd_pair):
    jsd, tsd, ids = sd_pair
    xt = np.random.default_rng(4).standard_normal((1, 8, 8, 4)).astype(np.float32)
    jimg, jtraj = jsd.generate_image(jnp.asarray(xt), prompt_ids=jnp.asarray(ids),
                                     num_inference_steps=STEPS, collect=True)
    runs = {mode: tsd.generate_image(torch.from_numpy(nchw(xt)), prompt_ids=ids,
                                     num_inference_steps=STEPS, collect=True, mode=mode)
            for mode in ("split", "fused")}
    (simg, straj), (fimg, ftraj) = runs["split"], runs["fused"]
    torch.testing.assert_close(fimg, simg, rtol=0, atol=0)
    torch.testing.assert_close(ftraj.xts, straj.xts, rtol=0, atol=0)
    assert tuple(fimg.shape) == (1, 3, 16, 16)  # the UNet's 8 x 8 latent
    np.testing.assert_allclose(fimg.numpy(), nchw(jimg), **EDIT)
    np.testing.assert_allclose(ftraj.xts.numpy(), np.asarray(jtraj.xts).transpose(0, 1, 4, 2, 3),
                               **EDIT)


def test_generate_images_draws_from_its_seed(sd_pair):
    _, tsd, ids = sd_pair
    a, traj, xt, zs = tsd.generate_images(num_images=2, eta=1.0, num_inference_steps=3,
                                          seed=5, prompt_ids=ids)
    b, _, xt_b, _ = tsd.generate_images(num_images=2, eta=1.0, num_inference_steps=3,
                                        seed=5, prompt_ids=ids)
    assert tuple(a.shape) == (2, 3, 16, 16) and tuple(zs.shape) == (3, 2, 4, 8, 8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and traj.xts is None
    c, _, xt_c, _ = tsd.generate_images(num_images=2, num_inference_steps=3, seed=6,
                                        prompt_ids=ids)
    assert not torch.equal(xt_c, xt)


def test_resynthesis_with_explicit_noise_matches_jax(sd_pair):
    import jax

    jsd, tsd, _ = sd_pair
    rng = np.random.default_rng(6)
    xt = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    zs = rng.standard_normal((STEPS, 1, 8, 8, 4)).astype(np.float32)
    mask = np.zeros((1, 8, 8, 4), np.float32)
    mask[:, 2:6, 1:5] = 1.0
    key = jax.random.PRNGKey(9)
    jxt, jzs = JEditPipeline(jsd).edit_noise_maps(jnp.asarray(xt), jnp.asarray(zs),
                                                  jnp.asarray(mask), True, key)
    k1, k2 = jax.random.split(key)
    fresh = (torch.from_numpy(nchw(np.array(jax.random.normal(k1, xt.shape)))),
             torch.from_numpy(np.array(jax.random.normal(k2, zs.shape)).transpose(0, 1, 4, 2, 3)))
    pipe = EditPipeline(tsd)
    txt, tzs = pipe.edit_noise_maps(torch.from_numpy(nchw(xt)),
                                    torch.from_numpy(zs.transpose(0, 1, 4, 2, 3)),
                                    torch.from_numpy(nchw(mask)), True, noise=fresh)
    np.testing.assert_allclose(txt.numpy(), nchw(jxt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tzs.numpy(), np.asarray(jzs).transpose(0, 1, 4, 2, 3), rtol=0,
                               atol=1e-6)
    # From a generator: fresh noise inside the mask, the maps kept outside.
    gxt, _ = pipe.edit_noise_maps(torch.from_numpy(nchw(xt)), None, torch.from_numpy(nchw(mask)),
                                  True, generator=torch.Generator().manual_seed(1))
    inside = torch.from_numpy(nchw(mask)).bool()
    assert torch.equal(gxt[~inside], torch.from_numpy(nchw(xt))[~inside])
    assert not torch.equal(gxt[inside], torch.from_numpy(nchw(xt))[inside])
    same, _ = pipe.edit_noise_maps(txt, None, torch.from_numpy(nchw(mask)), False)
    assert torch.equal(same, txt)


def test_ddim_prepare_then_fused_edit_matches_jax(sd_pair):
    """DDIM inversion (refined twice) under the prompt, then the fused edit
    with resynthesis inside a latent box, colour guidance and the same fresh
    noise, in both packages."""
    import jax

    jsd, tsd, ids = sd_pair
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((1, 16, 16, 4), np.float32)
    mask[:, 4:12, 4:12] = 1.0
    attr = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=1, t2=STEPS)
    jpipe, tpipe = JEditPipeline(jsd), EditPipeline(tsd)
    jxt, _, _, _, _ = jpipe.prepare_real_image_edit(jnp.asarray(img), prompt_ids=jnp.asarray(ids),
                                                    refine_iters=2)
    txt, zs, xts, _, _ = tpipe.prepare_real_image_edit(torch.from_numpy(nchw(img)),
                                                       prompt_ids=ids, refine_iters=2)
    assert zs is None and xts is None
    np.testing.assert_allclose(txt.numpy(), nchw(jxt), **EDIT)
    fused_xt, _ = tpipe.prepare_real_image_edit(torch.from_numpy(nchw(img)), prompt_ids=ids,
                                                refine_iters=2, mode="fused")[:2]
    torch.testing.assert_close(fused_xt, txt, rtol=0, atol=0)

    key = jax.random.PRNGKey(11)
    jout = jpipe.edit_image(jxt, mask=jnp.asarray(mask), attr_func=JSingleColor(**attr),
                            prompt_ids=jnp.asarray(ids), resynthesize=True, key=key)
    fresh = torch.from_numpy(nchw(np.array(jax.random.normal(jax.random.split(key)[0], jxt.shape))))
    tout = tpipe.edit_image(txt, mask=torch.from_numpy(nchw(mask)),
                            attr_func=SingleColorAttrFunc(**attr), prompt_ids=ids,
                            resynthesize=True, noise=(fresh, None), mode="fused")
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               np.asarray(jout.pred_original_samples).transpose(0, 1, 4, 2, 3),
                               **EDIT)


@pytest.mark.parametrize("mode", ["split", "fused", "batched"])
def test_ddpm_prepare_in_every_mode_matches_jax(sd_pair, mode):
    import jax

    jsd, tsd, ids = sd_pair
    img = np.random.default_rng(8).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jxt, jzs, jxts, _, _ = JEditPipeline(jsd).prepare_real_image_edit(
        jnp.asarray(img), eta=1.0, inversion_method="ddpm", prompt_ids=jnp.asarray(ids),
        key=key, mode=mode, t_skip=1)
    noise = np.asarray(jax.random.normal(key, (STEPS, 1, 16, 16, 4))).transpose(0, 1, 4, 2, 3)
    txt, tzs, txts, _, _ = EditPipeline(tsd).prepare_real_image_edit(
        torch.from_numpy(nchw(img)), eta=1.0, inversion_method="ddpm", prompt_ids=ids,
        noise=torch.from_numpy(np.ascontiguousarray(noise)), mode=mode, t_skip=1)
    np.testing.assert_allclose(tzs.numpy(), np.asarray(jzs).transpose(0, 1, 4, 2, 3), **EDIT)
    np.testing.assert_allclose(txts.numpy(), np.asarray(jxts).transpose(0, 1, 4, 2, 3), **EDIT)
    assert (float(tzs[0].abs().sum()) == 0.0) == (mode != "fused")  # t_skip's rows
