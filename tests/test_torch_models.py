"""The port's TINY SD UNet and KL-VAE against the JAX package's, weights
carried across with `state_dict_from_jax`, inputs from numpy.

Layout: JAX is NHWC, the port NCHW; the tests transpose at the boundary.
Tolerances: f32 on both sides, summation order only: rtol 1e-4, atol 1e-5
(observed ~2e-6 on outputs of magnitude ~2); the decode gradient adds one
backward pass: rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu_torch import models as TM
from tests.torch_port_helpers import nchw, tiny_unet_params, tiny_vae_params

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def unet_pair():
    ju, params = tiny_unet_params()
    tu = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(params, "unet_cond"))
    return ju, params, tu


@pytest.fixture(scope="module")
def vae_pair():
    jv, params = tiny_vae_params()
    tv = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
    tv.load_state_dict(TM.state_dict_from_jax(params, "vae"))
    return jv, params, tv


@pytest.mark.parametrize("t,ctx_len", [(np.int32(500), 7), (np.array([999, 1], np.int32), 77)])
def test_unet_forward_matches_jax(unet_pair, t, ctx_len):
    """Scalar and per-sample timesteps; a short and the 77-token context."""
    ju, params, tu = unet_pair
    rng = np.random.default_rng(ctx_len)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, ctx_len, 32)).astype(np.float32)
    ref = jax.jit(ju.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = tu(torch.from_numpy(nchw(x)), t, torch.from_numpy(ctx))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)


def test_unet_counts_its_attentions(unet_pair):
    """num_transformers (2 attentions each) sets the launch count a UNet call implies."""
    from diffusion_image_editing_tpu_torch.models.unet2d_cond import Transformer2D

    _, _, tu = unet_pair
    built = sum(isinstance(m, Transformer2D) for m in tu.modules())
    assert built == TM.TINY_SD_UNET.num_transformers == 4
    assert TM.SD15_UNET.num_transformers == 16  # 32 attentions per SD-1.5 UNet call


def test_vae_encode_decode_match_jax(vae_pair):
    jv, params, tv = vae_pair
    img = np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = jax.jit(lambda p, x: jv.apply(p, x, method="encode"))(params, jnp.asarray(img))
    rec = jax.jit(lambda p, z_: jv.apply(p, z_, method="decode"))(params, z)
    with torch.no_grad():
        tz = tv.encode(torch.from_numpy(nchw(img)))
        trec = tv.decode(tz)
    np.testing.assert_allclose(tz.numpy(), nchw(z), **FWD_TOL)
    np.testing.assert_allclose(trec.numpy(), nchw(rec), **FWD_TOL)


def test_vae_decode_gradient_matches_jax(vae_pair):
    """The guidance gradient's path: d(sum(decode(z) * w))/dz."""
    jv, params, tv = vae_pair
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    g_ref = jax.jit(jax.grad(lambda z_: jnp.sum(jv.apply(params, z_, method="decode") * w)))(
        jnp.asarray(z))
    tz = torch.from_numpy(nchw(z)).requires_grad_(True)
    (g,) = torch.autograd.grad((tv.decode(tz) * torch.from_numpy(nchw(w))).sum(), tz)
    np.testing.assert_allclose(g.numpy(), nchw(g_ref), **GRAD_TOL)


def test_bf16_model_casts_inputs():
    """Model compute in bf16 takes f32 inputs and returns f32 eps, as the
    JAX models with dtype=bfloat16 do."""
    tu = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu", dtype=torch.bfloat16)
    out = tu(torch.zeros(1, 4, 8, 8), 10, torch.zeros(1, 7, 32))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    tv = TM.AutoencoderKL(TM.TINY_VAE, device="cpu", dtype=torch.bfloat16)
    assert tv.decode(torch.zeros(1, 4, 16, 16)).dtype == torch.bfloat16


def test_model_constructors_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.UNet2DCondition(TM.TINY_SD_UNET)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.AutoencoderKL(TM.TINY_VAE)
