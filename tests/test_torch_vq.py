"""The port's VQ autoencoder (LDM's codec) and the KL autoencoder's moments
against the JAX package's, weights carried across with
`state_dict_from_jax`, inputs and noise from numpy.

VQModel at TINY_VQVAE (TINY_VAE's widths, a 3-channel latent, 64 codes):
the pre-quantization encode; the quantizer's code indices, bit-equal in
f32; the quantizing decode and its straight-through gradient. The KL
autoencoder's `encode_moments` (log-variance clipped to [-30, 20], here
also with weights that drive it past both ends) and `encode_sample` with
the noise passed as a tensor.

Tolerances: f32 on both sides, summation order only: rtol 1e-4, atol 1e-5
for forwards (observed about 1.5e-6), rtol 1e-3, atol 1e-4 for the decode
gradient (one backward pass more); at quant_conv gain g the moments' atol
is 1e-5 * g, and the sample's rtol gains half of it (exp(logvar / 2))."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu_torch import models as TM
from tests.torch_port_helpers import nchw, tiny_vae_params, tiny_vq_params

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def vq_pair():
    jv, params = tiny_vq_params()
    tv = TM.VQModel(TM.TINY_VQVAE, device="cpu")
    tv.load_state_dict(TM.state_dict_from_jax(params, "vq"))
    return jv, params, tv


def _img(seed, batch=2):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32)


def test_vq_encode_matches_jax(vq_pair):
    jv, params, tv = vq_pair
    img = _img(0)
    ref = jax.jit(lambda p, x: jv.apply(p, x, method="encode"))(params, jnp.asarray(img))
    with torch.no_grad():
        out = tv.encode(torch.from_numpy(nchw(img)))
    assert tuple(out.shape) == (2, 3, 16, 16)
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)


def test_quantizer_indices_bit_equal(vq_pair):
    """The codes the JAX quantizer picks (its output is z + (q - z), within
    an ulp of the code) are the port's `indices`, every one; the port's
    quantized latent is the code itself, f32."""
    jv, params, tv = vq_pair
    z = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)
    q = jax.jit(lambda p, h: jv.apply(p, h, method=lambda m, h: m.quantize(h)))(
        params, jnp.asarray(z))
    codes = np.asarray(params["params"]["quantize"]["embedding"])
    want = np.abs(np.asarray(q)[..., None, :] - codes).sum(-1).argmin(-1)  # (2, 16, 16)
    zt = torch.from_numpy(nchw(z))
    got = tv.quantize.indices(zt)
    assert got.dtype == torch.int64 and torch.equal(got, torch.from_numpy(want))
    assert len(np.unique(want)) > 8  # the latents spread over the codebook
    out = tv.quantize(zt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), nchw(codes[want]), rtol=0, atol=1e-6)


def test_quantizer_distances_in_f32_for_bf16(vq_pair):
    """A bf16 model's latent is quantized by f32 distances to its codebook:
    the indices are those of the f32 latent against the bf16-rounded codes."""
    _, _, tv = vq_pair
    bf = copy.deepcopy(tv).to(torch.bfloat16)
    z = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    f32 = TM.VectorQuantizer(64, 3, device="cpu")
    f32.embedding.weight.data.copy_(bf.quantize.embedding.weight.float())
    assert torch.equal(bf.quantize.indices(z), f32.indices(z.float()))
    assert bf.quantize(z).dtype == torch.float32


def test_vq_decode_and_gradient_match_jax(vq_pair):
    """The quantizing decode, and d(sum(decode(h) * w))/dh through the
    straight-through estimator (the guidance gradient's path)."""
    jv, params, tv = vq_pair
    rng = np.random.default_rng(3)
    h = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)

    def objective(p, h_):
        return jnp.sum(jv.apply(p, h_, method="decode") * w)

    ref = jax.jit(lambda p, h_: jv.apply(p, h_, method="decode"))(params, jnp.asarray(h))
    ref_grad = jax.jit(jax.grad(objective, argnums=1))(params, jnp.asarray(h))
    ht = torch.from_numpy(nchw(h)).requires_grad_(True)
    dec = tv.decode(ht)
    (grad,) = torch.autograd.grad((dec * torch.from_numpy(nchw(w))).sum(), ht)
    np.testing.assert_allclose(dec.detach().numpy(), nchw(ref), **FWD_TOL)
    np.testing.assert_allclose(grad.numpy(), nchw(ref_grad), **GRAD_TOL)
    # force_not_quantize decodes the latent as it is
    raw = jax.jit(lambda p, h_: jv.apply(p, h_, force_not_quantize=True, method="decode"))(
        params, jnp.asarray(h))
    with torch.no_grad():
        traw = tv.decode(torch.from_numpy(nchw(h)), force_not_quantize=True)
    np.testing.assert_allclose(traw.numpy(), nchw(raw), **FWD_TOL)


@pytest.mark.parametrize("gain", [1.0, 300.0])
def test_kl_moments_and_sample_match_jax(gain):
    """`encode_moments` (mean, clipped log-variance) and `encode_sample`
    with explicit noise; gain 300 on quant_conv drives the log-variance past
    -30 and 20, where the clip holds it."""
    jv, params = tiny_vae_params()
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["quant_conv"]["kernel"] = params["params"]["quant_conv"]["kernel"] * gain
    tv = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
    tv.load_state_dict(TM.state_dict_from_jax(params, "vae"))
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: jv.apply(p, x, method="encode_moments"))(
        params, jnp.asarray(img))
    with torch.no_grad():
        tmean, tlogvar = tv.encode_moments(torch.from_numpy(nchw(img)))
        sample = tv.encode_sample(torch.from_numpy(nchw(img)), torch.from_numpy(nchw(noise)))
        assert torch.equal(tv.encode(torch.from_numpy(nchw(img))), tmean)
    np.testing.assert_allclose(tmean.numpy(), nchw(mean), rtol=1e-4, atol=1e-5 * gain)
    np.testing.assert_allclose(tlogvar.numpy(), nchw(logvar), rtol=1e-4, atol=1e-5 * gain)
    want = np.asarray(mean) + np.exp(0.5 * np.asarray(logvar)) * noise
    # An absolute error e of the log-variance is a relative error e / 2 of
    # the sample: the log-variance's atol, halved, joins the sample's rtol.
    np.testing.assert_allclose(sample.numpy(), nchw(want), rtol=1e-4 + 5e-6 * gain,
                               atol=1e-5 * gain)
    if gain > 1:
        assert tlogvar.min().item() == -30.0 and tlogvar.max().item() == 20.0
