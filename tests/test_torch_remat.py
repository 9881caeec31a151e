"""The decoder's block checkpointing and the guidance options that ride on
it, against the JAX package, f32 on both sides: `decode(..., remat=True)`
of the KL and VQ autoencoders (and `decode_fn(remat_blocks=True)`),
`AttrFunc.remat_decode`, `vjp_chunk`, `metric="lpips"` with a `metric_fn`,
and `edit_image(decode_remat="blocks")`.

Checkpointing recomputes the same operations, so on the CPU the port's
checkpointed and plain runs are held bit-equal. Chunked VJPs batch the
decoder's convolutions, whose sums may run in another order: the chunks
1, 2 and 4 within rtol 1e-5, atol 1e-7. Against the JAX package:
decodes rtol 1e-4, atol 1e-5; decode gradients and nudges rtol 1e-3, atol
1e-4 (tests/test_torch_models.py's); the edits atol 1e-2
(tests/test_torch_pipeline.py's: the L1 colour loss has a sign gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.evals import lpips as JL
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu.pipeline.wrappers import LDM as JLDM
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.evals import LPIPS, make_lpips_fn
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models.layers import AttentionBlock2D, ResnetBlock2D
from diffusion_image_editing_tpu_torch.pipeline import DDPM, LDM, SD, EditPipeline
from tests.torch_port_helpers import (
    FixedTextSD, jax_params, nchw, tiny_unet2d_params, tiny_unet_params, tiny_vae_params,
    tiny_vq_params)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
CHUNK = dict(rtol=1e-5, atol=1e-7)
EDIT = dict(rtol=0, atol=1e-2)
STEPS = 4
COLOR = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)


@pytest.fixture(scope="module")
def codecs():
    """{"kl" | "vq": (JAX module, params, port module)}, the same weights."""
    out = {}
    for kind, (jm, params), cls, cfg in (
            ("kl", tiny_vae_params(), TM.AutoencoderKL, TM.TINY_VAE),
            ("vq", tiny_vq_params(), TM.VQModel, TM.TINY_VQVAE)):
        tm = cls(cfg, device="cpu")
        tm.load_state_dict(TM.state_dict_from_jax(params, "vae" if kind == "kl" else "vq"))
        out[kind] = (jm, jax.tree.map(jnp.asarray, params), tm.eval().requires_grad_(False))
    return out


@pytest.fixture(scope="module")
def wrappers(codecs):
    """(JAX wrapper, port wrapper) of each codec: SD's KL at 0.18215, LDM's VQ
    at 1.0."""
    unet, uparams = tiny_unet_params()
    tu = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(uparams, "unet_cond"))
    u2, u2params = tiny_unet2d_params()
    tu2 = TM.UNet2D(TM.TINY_UNET2D, device="cpu")
    tu2.load_state_dict(TM.state_dict_from_jax(u2params, "unet2d"))
    jkl, klp, tkl = codecs["kl"]
    jvq, vqp, tvq = codecs["vq"]
    return {
        "kl": (JSD(unet, uparams, j_schedule("sd", STEPS), jkl, klp),
               SD(tu, tkl, schedule_for_model("sd", STEPS), device="cpu")),
        "vq": (JLDM(u2, u2params, j_schedule("ldm", STEPS), jvq, vqp),
               LDM(tu2, schedule_for_model("ldm", STEPS), tvq, device="cpu")),
    }


def _latent(kind, batch=2, seed=0):
    c = 4 if kind == "kl" else 3
    return np.random.default_rng(seed).standard_normal((batch, 16, 16, c)).astype(np.float32)


class _Calls:
    """Counts the calls of each block of a module (forward pre-hooks: a
    checkpoint's recompute may stop inside a block's forward)."""

    def __init__(self, module, classes):
        self.n = 0
        self.handles = [m.register_forward_pre_hook(self._hook) for m in module.modules()
                        if isinstance(m, classes)]

    def _hook(self, module, args):
        self.n += 1

    def close(self):
        for h in self.handles:
            h.remove()


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_decode_and_input_gradient_with_and_without_remat(codecs, kind):
    """The same weights serve both modes: outputs and the input gradient are
    bit-equal, and against the JAX package's checkpointed decode. With
    remat, every ResnetBlock2D and the mid attention runs twice (the
    backward recomputes it), the decoder's other layers once."""
    jm, params, tm = codecs[kind]
    rng = np.random.default_rng(1)
    z = _latent(kind)
    w = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tw = torch.from_numpy(nchw(w))
    runs = {}
    for remat in (False, True):
        blocks = _Calls(tm.decoder, (ResnetBlock2D, AttentionBlock2D))
        conv_in = _Calls(tm.decoder.conv_in, torch.nn.Module)
        x = torch.from_numpy(nchw(z)).requires_grad_(True)
        out = tm.decode(x, remat=remat)
        (grad,) = torch.autograd.grad((out * tw).sum(), x)
        runs[remat] = (out.detach(), grad, blocks.n, conv_in.n)
        blocks.close()
        conv_in.close()
    n_blocks = sum(isinstance(m, (ResnetBlock2D, AttentionBlock2D))
                   for m in tm.decoder.modules())
    assert runs[False][2:] == (n_blocks, 1) and runs[True][2:] == (2 * n_blocks, 1)
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=0, atol=0)
    torch.testing.assert_close(runs[True][1], runs[False][1], rtol=0, atol=0)

    def j_decode(z_):
        return jm.apply(params, z_, remat=True, method="decode")

    ref = j_decode(jnp.asarray(z))
    jgrad = jax.grad(lambda z_: jnp.sum(j_decode(z_) * w))(jnp.asarray(z))
    np.testing.assert_allclose(runs[True][0].numpy(), nchw(ref), **FWD)
    np.testing.assert_allclose(runs[True][1].numpy(), nchw(jgrad), **GRAD)
    with torch.no_grad():  # without a gradient it is the plain forward
        torch.testing.assert_close(tm.decode(torch.from_numpy(nchw(z)), remat=True),
                                   runs[False][0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_decode_fn_remat_blocks(wrappers, kind):
    """`decode_fn(remat_blocks=True)` is the wrapper's codec with the
    checkpointed decoder, at the wrapper's latent scale."""
    jw, tw = wrappers[kind]
    plain, remat = tw.decode_fn(), tw.decode_fn(remat_blocks=True)
    assert remat.remat and not plain.remat and remat.scale == plain.scale
    z = _latent(kind, batch=1, seed=2)
    w = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32)
    jdec = jw.decode_fn(remat_blocks=True)
    jgrad = jax.grad(lambda z_: jnp.sum(jdec(z_) * w))(jnp.asarray(z))
    x = torch.from_numpy(nchw(z)).requires_grad_(True)
    (grad,) = torch.autograd.grad((remat(x) * torch.from_numpy(nchw(w))).sum(), x)
    np.testing.assert_allclose(grad.numpy(), nchw(jgrad), **GRAD)


def test_ddpm_identity_codec_is_one_closure(wrappers):
    _, tw = wrappers["vq"]
    ddpm = DDPM(tw.unet, tw.schedule, device="cpu")
    assert ddpm.decode_fn(remat_blocks=True) is ddpm.decode_fn()


def _nudge_inputs(kind, batch, seed):
    rng = np.random.default_rng(seed)
    x, z, eps = (_latent(kind, batch, s) for s in (seed, seed + 1, seed + 2))
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 8:24, 4:20] = 1.0
    ref = rng.uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32)
    return x, z, eps, mask, ref


def _apply(attr, w, x, z, eps, t, idx, dec, mask=None, x0=None, batched=True):
    fn = attr.apply_batched if batched else attr.apply
    if isinstance(x, np.ndarray):  # the JAX package
        return fn(jnp.asarray(x), jnp.asarray(z), jnp.asarray(eps), jnp.int32(t),
                  jnp.int32(idx), w.schedule, dec,
                  mask=None if mask is None else jnp.asarray(mask),
                  x0=None if x0 is None else jnp.asarray(x0))
    return fn(x, z, eps, t, idx, w.schedule, dec, mask=mask, x0=x0)


def _t(a):
    return None if a is None else torch.from_numpy(nchw(a))


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_remat_decode_nudge(wrappers, kind):
    """`remat_decode`: the whole decode under a checkpoint; the nudge equals
    the plain one (bit-equal) and the JAX package's."""
    jw, tw = wrappers[kind]
    x, z, eps, _, _ = _nudge_inputs(kind, 1, 4)
    idx = 1
    t = int(tw.schedule.timesteps[idx])
    jx, _ = _apply(JSingleColor(**COLOR, remat_decode=True), jw, x, z, eps, t, idx,
                   jw.decode_fn())
    runs = [_apply(SingleColorAttrFunc(**COLOR, remat_decode=r), tw, _t(x), _t(z), _t(eps), t,
                   idx, tw.decode_fn())[0] for r in (False, True)]
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)
    np.testing.assert_allclose(runs[1].numpy(), nchw(jx), **GRAD)
    assert (runs[1] - _t(x)).abs().max() > 0


def test_vjp_chunks_keep_per_sample_strength(wrappers):
    """`vjp_chunk` 1, 2 and 4 at batch 4 with SingleColorAttrFunc: each
    chunk runs one decode, and its objective is the sum of each sample's own
    loss, so each sample's nudge is the one it gets alone; a loss over the
    chunk as a whole would divide the colour loss's mean, and the nudge, by
    the chunk's size. Against the JAX package's `apply_batched(vjp_chunk=2)`."""
    jw, tw = wrappers["kl"]
    x, z, eps, _, _ = _nudge_inputs("kl", 4, 5)
    idx = 2
    t = int(tw.schedule.timesteps[idx])
    decodes = _Calls(tw.vae.decoder.conv_in, torch.nn.Module)
    outs = {}
    for chunk in (1, 2, 4):
        decodes.n = 0
        outs[chunk] = _apply(SingleColorAttrFunc(**COLOR, vjp_chunk=chunk), tw, _t(x), _t(z),
                             _t(eps), t, idx, tw.decode_fn())[0]
        assert decodes.n == 4 // chunk
    decodes.close()
    for chunk in (2, 4):
        torch.testing.assert_close(outs[chunk], outs[1], **CHUNK)
    jx, _ = _apply(JSingleColor(**COLOR, vjp_chunk=2), jw, x, z, eps, t, idx, jw.decode_fn())
    np.testing.assert_allclose(outs[2].numpy(), nchw(jx), **GRAD)
    # The dilution a loss over the whole batch would bring: a quarter of the nudge.
    whole = _apply(SingleColorAttrFunc(**COLOR), tw, _t(x), _t(z), _t(eps), t, idx,
                   tw.decode_fn(), batched=False)[0]
    torch.testing.assert_close((whole - _t(x)) * 4, outs[4] - _t(x), rtol=1e-4, atol=1e-6)


def test_vjp_chunk_takes_per_sample_masks_and_references(wrappers):
    """A chunk of 2 of a batch of 3 (a chunk of 2, then one of 1), with a
    per-sample x0 and a shared image mask (`mask_pred_original_sample`, l2
    background term), against the JAX package's chunked map."""
    jw, tw = wrappers["kl"]
    x, z, eps, mask, ref = _nudge_inputs("kl", 3, 6)
    idx = 1
    t = int(tw.schedule.timesteps[idx])
    kw = dict(COLOR, use_mask=True, mask_pred_original_sample=True, metric="l2", lambda_=0.3)
    jx, _ = _apply(JSingleColor(**kw, vjp_chunk=2), jw, x, z, eps, t, idx, jw.decode_fn(),
                   mask=mask, x0=ref)
    outs = [_apply(SingleColorAttrFunc(**kw, vjp_chunk=c), tw, _t(x), _t(z), _t(eps), t, idx,
                   tw.decode_fn(), mask=_t(mask), x0=_t(ref))[0] for c in (1, 2)]
    torch.testing.assert_close(outs[1], outs[0], **CHUNK)
    np.testing.assert_allclose(outs[1].numpy(), nchw(jx), **GRAD)


@pytest.fixture(scope="module")
def lpips_pair():
    jm = JL.LPIPS(width_mult=0.125)
    x = jnp.zeros((1, 32, 32, 3))
    params = jax_params(jm, 7, x, x)
    tm = LPIPS(0.125, device="cpu")
    tm.load_state_dict(TM.state_dict_from_jax(params, "lpips"))
    return JL.make_lpips_fn(params, width_mult=0.125), make_lpips_fn(tm)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat_blocks"])
def test_lpips_metric_masked_nudge_matches_jax(wrappers, lpips_pair, remat):
    """`metric="lpips"`: the background term is lambda * sum(LPIPS((1 - mask)
    * decoded, (1 - mask) * x0)), per sample at batch 2, through the
    (checkpointed) KL decode."""
    jw, tw = wrappers["kl"]
    j_fn, t_fn = lpips_pair
    x, z, eps, mask, ref = _nudge_inputs("kl", 2, 8)
    idx = 1
    t = int(tw.schedule.timesteps[idx])
    kw = dict(COLOR, use_mask=True, mask_pred_original_sample=True, metric="lpips",
              lambda_=0.5)
    jx, _ = _apply(JSingleColor(**kw, metric_fn=j_fn), jw, x, z, eps, t, idx,
                   jw.decode_fn(remat_blocks=remat), mask=mask, x0=ref)
    tx, _ = _apply(SingleColorAttrFunc(**kw, metric_fn=t_fn), tw, _t(x), _t(z), _t(eps), t,
                   idx, tw.decode_fn(remat_blocks=remat), mask=_t(mask), x0=_t(ref))
    np.testing.assert_allclose(tx.numpy(), nchw(jx), **GRAD)
    plain = _apply(SingleColorAttrFunc(**dict(kw, lambda_=0.0), metric_fn=t_fn), tw, _t(x),
                   _t(z), _t(eps), t, idx, tw.decode_fn(), mask=_t(mask), x0=_t(ref))[0]
    assert (tx - plain).abs().max() > 0  # the LPIPS term moved the nudge


def test_metric_options(lpips_pair):
    """As the JAX package: "lpips" needs a metric_fn; a metric_fn without a
    metric is used; neither raises."""
    _, t_fn = lpips_pair
    a = torch.rand(1, 3, 32, 32)
    b = torch.rand(1, 3, 32, 32)
    with pytest.raises(ValueError, match="requires metric_fn"):
        SingleColorAttrFunc(metric="lpips")._metric(a, b)
    with pytest.raises(ValueError, match="No metric"):
        SingleColorAttrFunc()._metric(a, b)
    torch.testing.assert_close(SingleColorAttrFunc(metric_fn=t_fn)._metric(a, b),
                               t_fn(a, b).sum())
    torch.testing.assert_close(SingleColorAttrFunc(metric="lpips", metric_fn=t_fn)._metric(a, b),
                               t_fn(a, b).sum())


@pytest.fixture(scope="module")
def remat_edits(wrappers):
    """A DDIM edit (eta 0) of a random latent guided by SingleColorAttrFunc
    with the l2 background term over an image box and x0_ref, at batch 2
    with vjp_chunk 2, through both packages' `edit_image` with
    decode_remat="blocks", and the port's with "auto"."""
    jw, tw = wrappers["kl"]
    rng = np.random.default_rng(9)
    text = rng.standard_normal((2, 77, 32)).astype(np.float32)
    xt = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    _, _, _, mask, ref = _nudge_inputs("kl", 2, 10)
    kw = dict(COLOR, use_mask=True, mask_pred_original_sample=True, metric="l2", lambda_=0.3,
              vjp_chunk=2)

    class JFixedTextSD(JSD):
        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    jpipe = JEditPipeline(JFixedTextSD(jw.unet, jw.unet_params, jw.schedule, jw.vae,
                                       jw.vae_params))
    jout = jpipe.edit_image(jnp.asarray(xt), eta=0.0, mask=jnp.asarray(mask),
                            x0_ref=jnp.asarray(ref), attr_func=JSingleColor(**kw),
                            mode="split", decode_remat="blocks")
    tpipe = EditPipeline(FixedTextSD(tw.unet, tw.vae, tw.schedule,
                                     text_emb=torch.from_numpy(text), device="cpu"))
    runs = {r: tpipe.edit_image(_t(xt), eta=0.0, mask=_t(mask), x0_ref=_t(ref),
                                attr_func=SingleColorAttrFunc(**kw), decode_remat=r)
            for r in ("blocks", "auto")}
    return jout, runs


def test_edit_image_decode_remat_blocks_matches_jax(remat_edits):
    jout, runs = remat_edits
    tout = runs["blocks"]
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               np.asarray(jout.pred_original_samples).transpose(0, 1, 4, 2, 3),
                               **EDIT)
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    torch.testing.assert_close(tout.imgs, runs["auto"].imgs, rtol=0, atol=0)
