"""The proxy guidance codec (`guidance/proxy.py`, `guidance_decode_proxy`,
`edit_image(guidance_codec="proxy")`) against the JAX package, with the
same weights and inputs (numpy, seeded, or JAX's own latents), f32 on both
sides.

Tolerances:
* the fit from the same latents: the decodes differ by summation order
  (about 1e-6) and the 5 x 5 normal equations are solved in f32, so w and b
  agree within rtol 1e-4, atol 1e-5;
* an affine decoder is recovered within atol 1e-4 (as JAX's
  tests/test_guidance_proxy.py), and proxy guidance equals full guidance
  for it within atol 1e-4;
* one NetAttrFunc nudge through the proxy: rtol 1e-4, atol 5e-5, as
  tests/test_torch_segguide.py;
* the proxy-guided edit: atol 1e-2, as tests/test_torch_slice.py (the L1
  colour loss has a sign gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.guidance import MultiColorAttrFunc as JMultiColor
from diffusion_image_editing_tpu.guidance import NetAttrFunc as JNetAttrFunc
from diffusion_image_editing_tpu.guidance import ProxyDecodeClosure as JProxy
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.guidance import fit_decode_proxy as j_fit
from diffusion_image_editing_tpu.models import bisenet as JB
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import (
    MultiColorAttrFunc, NetAttrFunc, ProxyDecodeClosure, SingleColorAttrFunc, fit_decode_proxy,
    solve_decode_proxy)
from diffusion_image_editing_tpu_torch.models import (
    TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition, state_dict_from_jax)
from diffusion_image_editing_tpu_torch.models import bisenet as TB
from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline
from tests.test_torch_bisenet import jax_variables
from tests.test_torch_segguide import HAIR, N_CLASSES, NUDGE, SEG_SIZE, WIDTH, seg_fns
from tests.torch_port_helpers import FixedTextSD, nchw, tiny_unet_params, tiny_vae_params

FIT_TOL = dict(rtol=1e-4, atol=1e-5)
EDIT = dict(rtol=0, atol=1e-2)
STEPS = 4


@pytest.fixture(scope="module")
def tiny_sd():
    unet, uparams = tiny_unet_params()
    vae, vparams = tiny_vae_params()
    tu = UNet2DCondition(TINY_SD_UNET, device="cpu")
    tu.load_state_dict(state_dict_from_jax(uparams, "unet_cond"))
    tv = AutoencoderKL(TINY_VAE, device="cpu")
    tv.load_state_dict(state_dict_from_jax(vparams, "vae"))
    jsd = JSD(unet, uparams, j_schedule("sd", STEPS), vae, vparams)
    tsd = SD(tu, tv, schedule_for_model("sd", STEPS), device="cpu")
    return jsd, tsd


def test_fit_from_jax_latents_matches_jax(tiny_sd):
    """JAX's fit draws its latents at its key; the port's solve takes the
    same latents and the port's decode of them."""
    jsd, tsd = tiny_sd
    key, n = jax.random.PRNGKey(0), 4
    ref = j_fit(jsd.decode_fn(), (8, 8, 4), key=key, n=n)
    z = torch.from_numpy(nchw(jax.random.normal(key, (n, 8, 8, 4), jnp.float32)).copy())
    with torch.no_grad():
        fit = solve_decode_proxy(z, tsd.decode_fn()(z))
    assert fit.up == ref.up == 2
    np.testing.assert_allclose(fit.w.numpy(), np.asarray(ref.w), **FIT_TOL)
    np.testing.assert_allclose(fit.b.numpy(), np.asarray(ref.b), **FIT_TOL)
    with pytest.raises(ValueError, match="integer multiple"):
        solve_decode_proxy(torch.zeros(1, 4, 8, 8), torch.zeros(1, 3, 12, 12))


def _affine(seed, c_in=4, c_out=3, up=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c_in, c_out)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    return JProxy(w=jnp.asarray(w), b=jnp.asarray(b), up=up), ProxyDecodeClosure(
        torch.from_numpy(w), torch.from_numpy(b), up)


def test_fit_recovers_an_affine_decoder_and_its_guidance():
    """As tests/test_guidance_proxy.py: the fit recovers an affine decoder
    exactly, and guidance through the fit equals guidance through it; the
    port's proxy applied to the same latent is JAX's."""
    jtrue, true = _affine(0)
    fit = fit_decode_proxy(true, (4, 8, 8), generator=torch.Generator().manual_seed(1), n=4)
    assert fit.up == 2
    np.testing.assert_allclose(fit.w.numpy(), true.w.numpy(), atol=1e-4)
    np.testing.assert_allclose(fit.b.numpy(), true.b.numpy(), atol=1e-4)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(true(torch.from_numpy(nchw(z))).numpy(), nchw(jtrue(z)),
                               rtol=1e-6, atol=1e-6)
    ts = schedule_for_model("sd", 6)
    kw = dict(r_target=0.8, g_target=0.1, b_target=0.1, loss_scale=10.0, t1=0, t2=6)
    xt, eps = (torch.from_numpy(nchw(rng.standard_normal((1, 8, 8, 4)).astype(np.float32)))
               for _ in range(2))
    t = int(ts.timesteps[2])
    a, _ = MultiColorAttrFunc(**kw).apply(xt, None, eps, t, 2, ts, true)
    b, _ = MultiColorAttrFunc(**kw).apply(xt, None, eps, t, 2, ts, fit)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    assert (a - xt).abs().max() > 0
    js = j_schedule("sd", 6)
    ja, _ = JMultiColor(**kw).apply(jnp.asarray(xt.numpy().transpose(0, 2, 3, 1)), None,
                                    jnp.asarray(eps.numpy().transpose(0, 2, 3, 1)),
                                    jnp.int32(t), jnp.int32(2), js, jtrue)
    np.testing.assert_allclose(a.numpy(), nchw(ja), rtol=1e-4, atol=5e-5)


def test_net_attr_nudge_through_the_proxy_matches_jax(tiny_sd):
    """NetAttrFunc composed with the proxy: the BiSeNet runs on the proxy's
    image, its gradient flows through the affine map."""
    jm = JB.BiSeNet(n_classes=N_CLASSES, width=WIDTH)
    variables = jax_variables(jm, seed=2)
    tm = TB.BiSeNet(n_classes=N_CLASSES, norm="bn", width=WIDTH)
    tm.load_state_dict(state_dict_from_jax(variables, "bisenet"), strict=True)
    jseg = JB.SegmentationModel(jm, variables, image_size=SEG_SIZE)
    j_fn, t_fn = seg_fns(jseg, TB.SegmentationModel(tm, image_size=SEG_SIZE))
    jproxy, proxy = _affine(3)
    jsd, tsd = tiny_sd
    js, ts = jsd.schedule, tsd.schedule
    rng = np.random.default_rng(4)
    x, eps = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32) for _ in range(2))
    kw = dict(loss_scale=200.0, t1=0, t2=STEPS, idx_for_class=(HAIR, 2))
    t = int(js.timesteps[1])
    jx, _ = JNetAttrFunc(seg_params=jseg.params, seg_apply_fn=j_fn, **kw).apply(
        jnp.asarray(x), None, jnp.asarray(eps), jnp.int32(t), jnp.int32(1), js, jproxy)
    tx, _ = NetAttrFunc(seg_apply_fn=t_fn, **kw).apply(
        torch.from_numpy(nchw(x)), None, torch.from_numpy(nchw(eps)), t, 1, ts, proxy)
    np.testing.assert_allclose(tx.numpy(), nchw(jx), **NUDGE)
    assert np.abs(tx.numpy() - nchw(x)).max() > 1e-3


def test_proxy_guided_edit_image_matches_jax(tiny_sd):
    """`edit_image(guidance_codec="proxy")` on the TINY SD, both wrappers
    given the same proxy; the proxy is fitted once and cached; the image is
    the real decoder's."""
    jsd0, tsd0 = tiny_sd
    rng = np.random.default_rng(5)
    text = rng.standard_normal((2, 7, 32)).astype(np.float32)
    xt = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)

    class JFixedTextSD(JSD):
        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    jsd = JFixedTextSD(jsd0.unet, jsd0.unet_params, jsd0.schedule, jsd0.vae, jsd0.vae_params)
    tsd = FixedTextSD(tsd0.unet, tsd0.vae, tsd0.schedule, text_emb=torch.from_numpy(text),
                      device="cpu")
    proxy = tsd.guidance_decode_proxy(generator=torch.Generator().manual_seed(0), n=4)
    assert tsd.guidance_decode_proxy() is proxy
    assert tsd.guidance_decode_proxy(refresh=True) is not proxy
    tsd._decode_proxy = proxy
    jsd._decode_proxy = JProxy(w=jnp.asarray(proxy.w.numpy()), b=jnp.asarray(proxy.b.numpy()),
                               up=proxy.up)
    attr = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)
    jout = JEditPipeline(jsd).edit_image(jnp.asarray(xt), attr_func=JSingleColor(**attr),
                                         guidance_codec="proxy", mode="split")
    pipe = EditPipeline(tsd)
    out = pipe.edit_image(torch.from_numpy(nchw(xt)), attr_func=SingleColorAttrFunc(**attr),
                          guidance_codec="proxy")
    np.testing.assert_allclose(out.pred_original_samples.numpy(),
                               np.asarray(jout.pred_original_samples).transpose(0, 1, 4, 2, 3),
                               **EDIT)
    np.testing.assert_allclose(out.imgs.numpy(), nchw(jout.imgs), **EDIT)
    assert tuple(out.imgs.shape) == (1, 3, 16, 16)
    full = pipe.edit_image(torch.from_numpy(nchw(xt)), attr_func=SingleColorAttrFunc(**attr))
    assert not torch.equal(out.imgs, full.imgs)
