"""Segmentation guidance, the port against the JAX package, same weights
and inputs (numpy, seeded), f32 on both sides, NCHW against NHWC: the class
mask (`MaskCreator`), `SegmentationModel`, `NetAttrFunc`, the BiSeNet
checkpoint loader, and the slice as a whole (`EditPipeline` with a
segmentation function: masked DDPM and DDIM inversion, then a masked,
resynthesized, `NetAttrFunc`-guided edit).

Tolerances:
* masks and the alpha channel: bit-equal;
* BiSeNet logits: max |port - jax| / max |jax| <= EVAL_TOL = 1e-5, as
  tests/test_torch_bisenet.py (convolutions summed in another order); the
  parsing map equal wherever JAX's top-2 logit margin exceeds 1e-4 (an
  argmax near-tie may go either way);
* one NetAttrFunc nudge: rtol 1e-4, atol 5e-5 (the guidance nudges of
  tests/test_torch_engine.py);
* inversion trajectories and noise maps: rtol 1e-4, atol 1e-3, and the
  guided edit's latents and image atol 1e-2, as tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.guidance import NetAttrFunc as JNetAttrFunc
from diffusion_image_editing_tpu.models import bisenet as JB
from diffusion_image_editing_tpu.ops import resize as JR
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu.pipeline.masks import MaskCreator as JMaskCreator
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import NetAttrFunc
from diffusion_image_editing_tpu_torch.models import (
    TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition, load_bisenet_checkpoint,
    state_dict_from_jax)
from diffusion_image_editing_tpu_torch.models import bisenet as TB
from diffusion_image_editing_tpu_torch.ops import resize as TR
from diffusion_image_editing_tpu_torch.pipeline import (
    SD, EditPipeline, MaskCreator, create_segmentation_model)
from tests.test_torch_bisenet import jax_variables
from tests.torch_port_helpers import (
    FixedTextSD, nchw, tiny_unet_params, tiny_vae_params, write_bisenet_checkpoint)

N_CLASSES, WIDTH, SEG_SIZE = 19, 8, 64
EVAL_TOL, MARGIN = 1e-5, 1e-4
NUDGE = dict(rtol=1e-4, atol=5e-5)
TRAJ = dict(rtol=1e-4, atol=1e-3)
EDIT = dict(rtol=0, atol=1e-2)
STEPS, T_SKIP = 4, 1
HAIR = 17


def nchw5(a):
    return np.asarray(a).transpose(0, 1, 4, 2, 3)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def parsing_map(size, seed):
    """A face-parsing-like map: random classes in coarse cells, a disc of
    class 17 (hair) that reaches the border, and a smaller disc of class 1."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, N_CLASSES, (size // 8 + 1, size // 8 + 1))
    out = np.kron(cells, np.ones((8, 8), np.int64))[:size, :size]
    yy, xx = np.mgrid[:size, :size]
    out[(yy - 0.1 * size) ** 2 + (xx - 0.6 * size) ** 2 < (0.35 * size) ** 2] = HAIR
    out[(yy - 0.7 * size) ** 2 + (xx - 0.3 * size) ** 2 < (0.15 * size) ** 2] = 1
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# MaskCreator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("classes", [(HAIR,), (HAIR, 1, 4)])
@pytest.mark.parametrize("size,out", [(64, 16), (32, 8), (512, 64)])
def test_mask_creator_matches_jax(dilate, classes, size, out):
    parsing = parsing_map(size, size + len(classes))
    want = JMaskCreator(dilate_mask=dilate, resize_size=(out, out)).create_mask(
        jnp.asarray(parsing), classes)
    creator = MaskCreator(dilate_mask=dilate, resize_size=(out, out))
    got = creator.create_mask(torch.from_numpy(parsing), classes)
    assert tuple(got.shape) == (1, 3, out, out) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    assert 0 < float(got.mean()) < 1  # neither empty nor full
    one = creator.create_class_mask(torch.from_numpy(parsing), HAIR)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(JMaskCreator(dilate_mask=dilate).create_class_mask(
            jnp.asarray(parsing), HAIR)))


# ---------------------------------------------------------------------------
# SegmentationModel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seg_pair():
    jm = JB.BiSeNet(n_classes=N_CLASSES, width=WIDTH)
    variables = jax_variables(jm, seed=2)
    tm = TB.BiSeNet(n_classes=N_CLASSES, norm="bn", width=WIDTH)
    tm.load_state_dict(state_dict_from_jax(variables, "bisenet"), strict=True)
    return (JB.SegmentationModel(jm, variables, image_size=SEG_SIZE),
            TB.SegmentationModel(tm, image_size=SEG_SIZE))


def test_segmentation_logits_match_jax(seg_pair):
    jseg, tseg = seg_pair
    x = np.random.default_rng(3).standard_normal((2, SEG_SIZE, SEG_SIZE, 3)).astype(np.float32)
    want = np.asarray(jseg.logits_fn(jseg.params, jnp.asarray(x)))
    img = torch.from_numpy(nchw(x)).requires_grad_(True)
    got = tseg.logits_fn(img)
    assert tuple(got.shape) == (2, N_CLASSES, SEG_SIZE, SEG_SIZE)
    assert _rel(got.detach().numpy(), nchw(want)) <= EVAL_TOL
    (grad,) = torch.autograd.grad(got[:, HAIR].sum(), img)  # differentiable in the image
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    assert not tseg.module.training
    assert not any(p.requires_grad for p in tseg.module.parameters())


@pytest.mark.parametrize("size", [48, 96])
def test_parsing_map_matches_jax_off_near_ties(seg_pair, size):
    """From a [-1, 1] image of another size (resized to 64 with the
    antialiased bilinear resize), the first image's argmax map."""
    jseg, tseg = seg_pair
    img = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jseg(jnp.asarray(img)))
    got = tseg(torch.from_numpy(nchw(img)))
    assert tuple(got.shape) == (SEG_SIZE, SEG_SIZE) and not got.is_floating_point()
    x = JR.imagenet_normalize(JR.to_unit_range(JR.resize_bilinear(jnp.asarray(img), SEG_SIZE,
                                                                   SEG_SIZE)))
    logits = np.sort(np.asarray(jseg.logits_fn(jseg.params, x))[0], axis=-1)
    clear = logits[..., -1] - logits[..., -2] > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    first = tseg(torch.from_numpy(nchw(img[:1])))  # the batch's first image alone
    assert torch.equal(first, got)


# ---------------------------------------------------------------------------
# The checkpoint loader and the factory
# ---------------------------------------------------------------------------


def test_bisenet_checkpoint_loads_as_the_jax_loader_reads_it(tmp_path):
    from diffusion_image_editing_tpu.models.port import load_bisenet_checkpoint as j_load

    path = str(tmp_path / "79999_iter.pth")
    state = write_bisenet_checkpoint(path, seed=5)
    module = load_bisenet_checkpoint(path, device="cpu")
    assert (module.n_classes, module.width, module.norm) == (N_CLASSES, WIDTH, "bn")
    loaded = module.state_dict()
    assert set(loaded) == set(state)
    assert all(torch.equal(loaded[k], v) for k, v in state.items())
    x = np.random.default_rng(6).standard_normal((1, SEG_SIZE, SEG_SIZE, 3)).astype(np.float32)
    want = JB.BiSeNet(n_classes=N_CLASSES, width=WIDTH).apply(j_load(path), jnp.asarray(x))[0]
    got = TB.SegmentationModel(module).logits_fn(torch.from_numpy(nchw(x)))
    assert _rel(got.numpy(), nchw(want)) <= EVAL_TOL
    # a bare state dict, without "state_dict" or "module.", loads too
    torch.save(state, tmp_path / "bare.pth")
    bare = load_bisenet_checkpoint(str(tmp_path / "bare.pth"), device="cpu").state_dict()
    assert all(torch.equal(bare[k], v) for k, v in state.items())


def test_create_segmentation_model(tmp_path, capsys):
    path = str(tmp_path / "seg.pth")
    write_bisenet_checkpoint(path, seed=1)
    seg = create_segmentation_model(path, width=WIDTH, device="cpu")
    assert isinstance(seg, TB.SegmentationModel) and seg.image_size == 512
    assert "random-init" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="width 8"):
        create_segmentation_model(path, device="cpu")  # the default width is 64
    rand = create_segmentation_model(width=WIDTH, device="cpu")
    assert "random-init" in capsys.readouterr().err
    again = create_segmentation_model(width=WIDTH, device="cpu")  # seeded
    for a, b in zip(rand.module.state_dict().values(), again.module.state_dict().values()):
        assert torch.equal(a, b)
    parsing = rand(torch.rand(1, 3, 40, 40) * 2 - 1)
    assert tuple(parsing.shape) == (512, 512)


# ---------------------------------------------------------------------------
# NetAttrFunc
# ---------------------------------------------------------------------------


def seg_fns(jseg, tseg):
    """Both packages' segmentation callables for guidance, on the decoded
    image: resize to 64 (the TINY decode is 32 or 16 px), [0, 1], ImageNet
    normalisation, BiSeNet's first head."""
    def j_fn(params, img):
        x = JR.resize_bilinear(img.astype(jnp.float32), SEG_SIZE, SEG_SIZE)
        return jseg.module.apply(params, JR.imagenet_normalize(JR.to_unit_range(x)))[0]

    def t_fn(img):
        x = TR.resize_bilinear(img.float(), SEG_SIZE, SEG_SIZE)
        return tseg.logits_fn(TR.imagenet_normalize(TR.to_unit_range(x)))

    return j_fn, t_fn


@pytest.fixture(scope="module")
def tiny_sd():
    """The TINY SD UNet and VAE in both packages, the same seeded weights."""
    unet, uparams = tiny_unet_params()
    vae, vparams = tiny_vae_params()
    tu = UNet2DCondition(TINY_SD_UNET, device="cpu")
    tu.load_state_dict(state_dict_from_jax(uparams, "unet_cond"))
    tv = AutoencoderKL(TINY_VAE, device="cpu")
    tv.load_state_dict(state_dict_from_jax(vparams, "vae"))
    return (unet, uparams, vae, vparams), (tu, tv)


GUIDE = dict(loss_scale=200.0, t1=0, t2=STEPS, idx_for_class=(HAIR, 2))
# name -> (attr kwargs, latent mask, image mask and x0)
NET_NUDGES = {
    "plain": (dict(GUIDE), False, False),
    "use_mask": (dict(GUIDE, use_mask=True), False, False),
    "mask_attr_grad": (dict(GUIDE, use_mask=True, mask_attr_grad=True), True, False),
    "mask_pred_x0": (dict(GUIDE, use_mask=True, mask_pred_original_sample=True, metric="l2",
                          lambda_=0.3), False, True),
}


@pytest.mark.parametrize("case", sorted(NET_NUDGES))
def test_net_attr_nudge_through_the_tiny_decode_matches_jax(seg_pair, tiny_sd, case):
    jseg, tseg = seg_pair
    (unet, uparams, vae, vparams), (tu, tv) = tiny_sd
    kw, latent_mask, image_mask = NET_NUDGES[case]
    js, ts = j_schedule("sd", STEPS), schedule_for_model("sd", STEPS)
    jdec = JSD(unet, uparams, js, vae, vparams).decode_fn()
    tdec = SD(tu, tv, ts, device="cpu").decode_fn()
    j_fn, t_fn = seg_fns(jseg, tseg)
    rng = np.random.default_rng(len(case))
    x, eps = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32) for _ in range(2))
    mask = x0 = None
    if latent_mask:
        mask = np.repeat((rng.uniform(size=(1, 16, 16, 1)) > 0.5).astype(np.float32), 4, -1)
    if image_mask:
        mask = np.repeat((rng.uniform(size=(1, 32, 32, 1)) > 0.5).astype(np.float32), 3, -1)
        x0 = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    idx = 1
    t = int(js.timesteps[idx])
    jx, _ = JNetAttrFunc(seg_params=jseg.params, seg_apply_fn=j_fn, **kw).apply(
        jnp.asarray(x), None, jnp.asarray(eps), jnp.int32(t), jnp.int32(idx), js, jdec,
        mask=None if mask is None else jnp.asarray(mask),
        x0=None if x0 is None else jnp.asarray(x0))
    tx, _ = NetAttrFunc(seg_apply_fn=t_fn, **kw).apply(
        torch.from_numpy(nchw(x)), None, torch.from_numpy(nchw(eps)), t, idx, ts, tdec,
        mask=None if mask is None else torch.from_numpy(nchw(mask)),
        x0=None if x0 is None else torch.from_numpy(nchw(x0)))
    np.testing.assert_allclose(tx.numpy(), nchw(jx), **NUDGE)
    moved = np.abs(nchw(jx) - nchw(x)).max()
    assert moved > 1e-3  # the nudge is not lost below the tolerance
    if latent_mask:  # no nudge outside the latent mask
        outside = nchw(mask) == 0
        np.testing.assert_array_equal(tx.numpy()[outside], nchw(x)[outside])


# ---------------------------------------------------------------------------
# The slice: EditPipeline with a segmentation function
# ---------------------------------------------------------------------------

PARSING = parsing_map(32, 7)  # at the 16 px image's double; the mask is 8 x 8


@pytest.fixture(scope="module")
def pipes(tiny_sd):
    (unet, uparams, vae, vparams), (tu, tv) = tiny_sd
    text = np.random.default_rng(0).standard_normal((2, 77, 32)).astype(np.float32)

    class JFixedTextSD(JSD):
        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    jsd = JFixedTextSD(unet, uparams, j_schedule("sd", STEPS), vae, vparams)
    tsd = FixedTextSD(tu, tv, schedule_for_model("sd", STEPS), text_emb=torch.from_numpy(text),
                      device="cpu")
    # one fixed parsing map in both packages, so that no argmax tie can differ
    jpipe = JEditPipeline(jsd, segmentation_fn=lambda img: jnp.asarray(PARSING))
    tpipe = EditPipeline(tsd, segmentation_fn=lambda img: torch.from_numpy(PARSING))
    img = np.random.default_rng(1).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    return jpipe, tpipe, img


def _prepare_both(pipes, method, mode, dilate):
    jpipe, tpipe, img = pipes
    key = jax.random.PRNGKey(4)
    eta = 1.0 if method == "ddpm" else 0.0
    t_skip = T_SKIP if method == "ddpm" else None
    jout = jpipe.prepare_real_image_edit(jnp.asarray(img), eta=eta, inversion_method=method,
                                         classes=[HAIR], dilate_mask=dilate, key=key, mode=mode,
                                         t_skip=t_skip)
    noise = None
    if method == "ddpm":  # the trajectory noise JAX's sample_xts draws from the key
        noise = torch.from_numpy(nchw5(jax.random.normal(key, (STEPS, 1, 8, 8, 4))).copy())
    tout = tpipe.prepare_real_image_edit(torch.from_numpy(nchw(img)), eta=eta,
                                         inversion_method=method, classes=[HAIR],
                                         dilate_mask=dilate, noise=noise, mode=mode,
                                         t_skip=t_skip)
    return jout, tout


@pytest.mark.parametrize("dilate", [False, True], ids=["mask", "dilated"])
@pytest.mark.parametrize("method,mode", [("ddpm", "split"), ("ddpm", "batched"),
                                         ("ddim", "split")])
def test_masked_prepare_matches_jax(pipes, method, mode, dilate):
    (jxt, jzs, jxts, jmask, jparsing), (txt, tzs, txts, tmask, tparsing) = _prepare_both(
        pipes, method, mode, dilate)
    assert tuple(tmask.shape) == (1, 4, 8, 8)  # 3 mask channels + SD's alpha channel
    np.testing.assert_array_equal(tmask.numpy(), nchw(jmask))
    assert torch.equal(tmask[:, 3], torch.ones(1, 8, 8))
    assert 0 < float(tmask[:, 0].mean()) < 1
    assert torch.equal(tparsing, torch.from_numpy(PARSING))
    np.testing.assert_array_equal(np.asarray(jparsing), PARSING)
    np.testing.assert_allclose(txt.numpy(), nchw(jxt), **TRAJ)
    if method == "ddpm":
        np.testing.assert_allclose(tzs.numpy(), nchw5(jzs), **TRAJ)
        np.testing.assert_allclose(txts.numpy(), nchw5(jxts), **TRAJ)
    else:
        assert tzs is None and txts is None


def test_masks_with_and_without_dilation_differ(pipes):
    """The dilation widens the mask (a check that the option reaches it)."""
    masks = [_prepare_both(pipes, "ddim", "split", d)[1][3] for d in (False, True)]
    assert float(masks[1].sum()) > float(masks[0].sum())
    assert torch.equal(masks[0] * masks[1], masks[0])


def test_classes_are_checked(pipes):
    _, tpipe, img = pipes
    with pytest.raises(ValueError, match="out of range"):
        tpipe.prepare_for_edit(torch.from_numpy(nchw(img)), classes=[19])
    with pytest.raises(ValueError, match="out of range"):
        tpipe.check_classes([-1])
    tpipe.check_classes(None)
    tpipe.check_classes(list(range(19)))


@pytest.fixture(scope="module")
def guided_edits(pipes, seg_pair):
    """DDPM inversion (batched, t_skip 1, 4 steps) with the hair mask, then
    a 3-step masked, resynthesized, NetAttrFunc-guided edit in both
    packages, with the same fresh noise; and the port's unguided edit."""
    jpipe, tpipe, _ = pipes
    jseg, tseg = seg_pair
    j_fn, t_fn = seg_fns(jseg, tseg)
    (jxt, jzs, jxts, jmask, _), (txt, tzs, txts, tmask, _) = _prepare_both(
        pipes, "ddpm", "batched", False)
    key = jax.random.PRNGKey(8)
    jattr = JNetAttrFunc(seg_params=jseg.params, seg_apply_fn=j_fn,
                         **dict(GUIDE, idx_for_class=(HAIR,)))
    jout = jpipe.edit_image(jxt, eta=1.0, zs=jzs, xts=jxts, mask=jmask, attr_func=jattr,
                            inversion_method="ddpm", t_skip=T_SKIP, resynthesize=True, key=key,
                            mode="split")
    k1, k2 = jax.random.split(key)
    fresh = (torch.from_numpy(nchw(jax.random.normal(k1, jxt.shape)).copy()),
             torch.from_numpy(nchw5(jax.random.normal(k2, jzs.shape)).copy()))
    runs = {}
    for name, t1 in (("guided", 0), ("unguided", STEPS)):
        attr = NetAttrFunc(seg_apply_fn=t_fn, **dict(GUIDE, idx_for_class=(HAIR,), t1=t1))
        runs[name] = tpipe.edit_image(txt, eta=1.0, zs=tzs, xts=txts, mask=tmask,
                                      attr_func=attr, inversion_method="ddpm", t_skip=T_SKIP,
                                      resynthesize=True, noise=fresh, mode="split")
    return jout, runs, t_fn


def test_masked_resynthesized_net_guided_edit_matches_jax(guided_edits):
    jout, runs, _ = guided_edits
    tout = runs["guided"]
    assert tout.model_outputs.shape[0] == STEPS - T_SKIP
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               nchw5(jout.pred_original_samples), **EDIT)
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    assert torch.isfinite(tout.imgs).all()


def test_net_guidance_moves_the_edit(guided_edits):
    """The guided edit differs from the unguided one from the same inversion
    and noise, and the hair class's probability mass moved (the loss the
    nudge descends is the class mass, so it falls)."""
    _, runs, t_fn = guided_edits
    guided, unguided = runs["guided"].imgs, runs["unguided"].imgs
    assert (guided - unguided).abs().max() > 1e-3
    mass = [float(torch.softmax(t_fn(x), dim=1)[:, HAIR].mean()) for x in (guided, unguided)]
    assert mass[0] < mass[1]
