"""The port's conv modes (`ops/conv.py`: xla, shift9, int8, int8_large,
`int8_bwd`) against the JAX package's `ops/conv.py`, with the same numpy
inputs. The JAX modes are set as its own tests set them, by
`monkeypatch.setenv` around un-jitted calls; the port's by `conv_mode`.

Layout: JAX NHWC / HWIO, the port NCHW / OIHW. Tolerances, f32 on both
sides: xla and shift9 differ by summation order only (rtol 1e-5, atol
1e-5). The int8 product is exact in both, and both quantize the same f32
values with the same scales, so the int8 forward agrees to f32 rounding
(rtol 1e-6, atol 1e-6 of outputs near 1). The int8 dgrad quantizes a
cotangent that differs between the frameworks by f32 rounding: held within
1e-5. A decode through stacked int8 convs quantizes activations that
differ by rounding, and a value at a rounding boundary can move by one
quantization step: held within 1e-3 relative (L2) of JAX's int8 decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_image_editing_tpu.ops import conv as JC
from diffusion_image_editing_tpu_torch.ops import conv as TC

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-6, atol=1e-6)


def _data(b=2, h=8, w=8, cin=12, cout=20, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, wgt


def _port(x, wgt, grad=False):
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(grad)
    tw = torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()).requires_grad_(grad)
    return tx, tw


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _oihw(a):
    return np.asarray(a).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("mode", ["xla", "shift9"])
def test_exact_modes_match_jax_with_gradients(mode):
    x, wgt = _data(b=1, h=6, w=6, cin=8, cout=8)
    jfn = JC.conv3x3_xla if mode == "xla" else JC.conv3x3_shift9
    ref = jfn(jnp.asarray(x), jnp.asarray(wgt))
    gx, gw = jax.grad(lambda a, b: jnp.sum(jnp.sin(jfn(a, b))), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wgt))
    tx, tw = _port(x, wgt, grad=True)
    before = dict(TC.CALL_COUNTS)
    with TC.conv_mode(mode):
        out = TC.conv3x3(tx, tw)
    assert TC.CALL_COUNTS[mode] == before[mode] + 1
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _nchw(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _nchw(gx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), _oihw(gw), **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 12, 20), (1, 5, 7, 3, 4)])
def test_int8_forward_matches_jax(shape):
    """Odd widths too: the port pads Cin / Cout to multiples of 8 and the
    rows past 16 for `torch._int_mm`, which must be exact."""
    b, h, w, cin, cout = shape
    x, wgt = _data(b, h, w, cin, cout, seed=1)
    ref = JC.conv3x3_int8(jnp.asarray(x), jnp.asarray(wgt))
    tx, tw = _port(x, wgt)
    out = TC.conv3x3_int8(tx, tw)
    np.testing.assert_allclose(out.numpy(), _nchw(ref), **INT8_TOL)
    # and it is a quantized conv: close to, not equal to, the exact one
    exact = F.conv2d(tx, tw, padding=1)
    rel = float((out - exact).norm() / exact.norm())
    assert 0 < rel < 0.05, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_zero_input_and_dtype(dtype):
    """An all-zero tensor gets scale 1 (no 0/0); the output keeps the
    input's dtype, as JAX's `astype(x.dtype)`."""
    x = torch.zeros(1, 8, 16, 16, dtype=dtype)
    w = torch.randn(8, 8, 3, 3, generator=torch.Generator().manual_seed(0)).to(dtype)
    y = TC.conv3x3_int8(x, w)
    assert y.dtype == dtype and torch.equal(y, torch.zeros_like(y))
    y = TC.conv3x3_int8(torch.ones_like(x), torch.zeros_like(w))
    assert torch.equal(y, torch.zeros_like(y))


def test_int8_backward_is_the_exact_vjp():
    """Straight-through: dx and dw of the int8 conv are the exact conv's VJP
    at the unquantized operands, bit for bit."""
    x, wgt = _data(b=1, h=16, w=16, cin=8, cout=8, seed=2)
    tx, tw = _port(x, wgt, grad=True)
    torch.sin(TC.conv3x3_int8(tx, tw)).sum().backward()
    g = torch.cos(TC.conv3x3_int8(tx, tw)).detach()
    ex, ew = _port(x, wgt, grad=True)
    F.conv2d(ex, ew, padding=1).backward(g)
    torch.testing.assert_close(tx.grad, ex.grad, rtol=0, atol=0)
    torch.testing.assert_close(tw.grad, ew.grad, rtol=0, atol=0)


def test_int8_bwd_dgrad_matches_jax_and_dw_stays_exact(monkeypatch):
    x, wgt = _data(b=1, h=16, w=16, cin=8, cout=8)

    def loss(a, b):
        return jnp.sum(jnp.sin(JC.conv3x3_int8(a, b)))

    monkeypatch.setenv("DIE_TPU_INT8_BWD", "0")
    _, gw0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wgt))
    monkeypatch.setenv("DIE_TPU_INT8_BWD", "1")
    gx1, gw1 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wgt))

    grads = {}
    for bwd in (False, True):
        tx, tw = _port(x, wgt, grad=True)
        torch.sin(TC.conv3x3_int8(tx, tw, int8_bwd=bwd)).sum().backward()
        grads[bwd] = tx.grad, tw.grad
    torch.testing.assert_close(grads[True][1], grads[False][1], rtol=0, atol=0)
    np.testing.assert_allclose(grads[True][0].numpy(), _nchw(gx1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[True][1].numpy(), _oihw(gw1), **TOL)
    np.testing.assert_allclose(grads[False][1].numpy(), _oihw(gw0), **TOL)
    a, b = grads[False][0].double().ravel(), grads[True][0].double().ravel()
    assert float(a @ b / (a.norm() * b.norm())) > 0.995


def test_modes_are_settings_not_environment(monkeypatch):
    """`conv_mode` restores the previous settings; the environment is not
    read; a bad mode raises; the default Conv3x3 is `F.conv2d` bit for bit;
    an int8 conv's backward takes its forward's `int8_bwd`."""
    monkeypatch.setenv("DIE_TPU_CONV", "int8")
    assert TC.conv_settings() == {"mode": "xla", "min_h": 128, "int8_bwd": False}
    assert TC.INT8_MIN_H_DEFAULT == JC._INT8_MIN_H_DEFAULT
    conv = TC.Conv3x3(5, 7, device="cpu")
    x = torch.randn(2, 5, 9, 9, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(conv(x), F.conv2d(x, conv.weight, conv.bias, padding=1),
                               rtol=0, atol=0)
    with TC.conv_mode("int8_large", min_h=9, int8_bwd=True):
        assert TC.conv_settings() == {"mode": "int8_large", "min_h": 9, "int8_bwd": True}
        xg = x.clone().requires_grad_(True)
        y = conv(xg)
    assert TC.conv_settings()["mode"] == "xla"
    y.sum().backward()  # after the block: still the int8 dgrad of the forward
    want = TC.conv3x3_int8(x, conv.weight.detach()) + conv.bias.detach()[:, None, None]
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=0)
    xe = x.clone().requires_grad_(True)
    TC.conv3x3_int8(xe, conv.weight.detach(), int8_bwd=True).sum().backward()
    torch.testing.assert_close(xg.grad, xe.grad, rtol=0, atol=0)
    with pytest.raises(ValueError, match="conv mode"):
        TC.set_conv_mode("bogus")


def test_int8_large_gates_on_spatial_size():
    w = torch.randn(8, 8, 3, 3) * 0.1
    before = dict(TC.CALL_COUNTS)
    with TC.conv_mode("int8_large", min_h=32):
        TC.conv3x3(torch.randn(1, 8, 16, 16), w)
        assert TC.CALL_COUNTS["int8"] == before["int8"]
        assert TC.CALL_COUNTS["xla"] == before["xla"] + 1
        TC.conv3x3(torch.randn(1, 8, 32, 32), w)
        assert TC.CALL_COUNTS["int8"] == before["int8"] + 1


def test_int8_large_decode_matches_jax(monkeypatch):
    """A TINY VAE decode (JAX's test config: stages at 32 and 64 px) with
    int8_large at min_h 32, against the JAX package's decode under
    DIE_TPU_CONV=int8_large, DIE_TPU_INT8_MIN_H=32; int8 convs ran."""
    from diffusion_image_editing_tpu.models.vae import AutoencoderConfig as JCfg
    from diffusion_image_editing_tpu.models.vae import AutoencoderKL as JVAE
    from diffusion_image_editing_tpu_torch.models import AutoencoderConfig, AutoencoderKL
    from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
    from tests.torch_port_helpers import jax_params

    kw = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
              norm_num_groups=4, sample_size=64)
    jvae = JVAE(JCfg(**kw))
    params = jax_params(jvae, 4, jnp.zeros((1, 64, 64, 3)))
    tvae = AutoencoderKL(AutoencoderConfig(**kw), device="cpu")
    tvae.load_state_dict(state_dict_from_jax(params, "vae"))
    z = np.random.default_rng(3).standard_normal((1, 32, 32, 4)).astype(np.float32)

    monkeypatch.setenv("DIE_TPU_CONV", "xla")
    ref_xla = np.asarray(jvae.apply(params, jnp.asarray(z), method="decode"))
    monkeypatch.setenv("DIE_TPU_CONV", "int8_large")
    monkeypatch.setenv("DIE_TPU_INT8_MIN_H", "32")
    ref = np.asarray(jvae.apply(params, jnp.asarray(z), method="decode"))

    before = TC.CALL_COUNTS["int8"]
    with TC.conv_mode("int8_large", min_h=32), torch.no_grad():
        out = tvae.decode(torch.from_numpy(_nchw(z).copy())).numpy()
    assert TC.CALL_COUNTS["int8"] > before
    rel = np.linalg.norm(out - _nchw(ref)) / np.linalg.norm(ref)
    assert rel < 1e-3, rel
    quant = np.linalg.norm(_nchw(ref) - _nchw(ref_xla)) / np.linalg.norm(ref_xla)
    assert rel < quant < 0.15, (rel, quant)


def test_segmentation_convs_follow_the_mode():
    """BiSeNet's and ResNet-18's 3x3 stride-1 convs take the conv mode, as
    the JAX package's `Conv3x3` there; the stem and strided convs do not."""
    from diffusion_image_editing_tpu_torch.models.resnet import Conv

    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(5))
    plain = Conv(8, 8, 3, 1, 1, device="cpu")
    routed = Conv(8, 8, 3, 1, 1, dispatch=True, device="cpu")
    routed.load_state_dict(plain.state_dict())
    assert not Conv(8, 8, 3, 2, 1, dispatch=True, device="cpu").dispatch
    torch.testing.assert_close(routed(x), plain(x), rtol=0, atol=0)
    with TC.conv_mode("int8"):
        torch.testing.assert_close(routed(x), TC.conv3x3_int8(x, plain.weight), rtol=0, atol=0)
        torch.testing.assert_close(plain(x), F.conv2d(x, plain.weight, padding=1), rtol=0,
                                   atol=0)
