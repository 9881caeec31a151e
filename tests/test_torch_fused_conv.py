"""The port's fused GroupNorm+SiLU -> conv3x3 against the JAX package's,
same inputs from numpy.

On the CPU the port's `affine_silu_conv3x3` runs its plain version through
the same autograd function the card uses (the hand-written backward of JAX's
`_fused_vjp_bwd`, in torch ops); the JAX side runs `_jnp_fwd`, its Pallas
kernel in interpret mode (as tests/test_fused_conv.py does) and `jax.grad`
of its custom-VJP `affine_silu_conv3x3`. The CUDA kernel itself is held
against the plain version on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py).

Layout: JAX is NHWC with HWIO kernels, the port NCHW with OIHW; the tests
transpose at the boundary. Tolerances, f32 on both sides:
  * (A, B): rtol 1e-5, atol 1e-5 (moments in another order; Welford in
    the port, two passes in JAX); at mean 50, atol 1e-4 on B, whose
    entries are about 50 * rstd;
  * the conv forward: rtol 1e-4, atol 1e-5 (sums of 9 * Cin products in
    another order);
  * gradients: rtol 1e-3, atol 1e-4 (one more product each; da, db and dw
    are sums over all pixels);
  * ResnetBlock2D and the tiny models: rtol 1e-4, atol 1e-5 for outputs,
    rtol 1e-3, atol 1e-4 for the decode's gradient (as
    tests/test_torch_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_image_editing_tpu_torch.ops as OPS
from diffusion_image_editing_tpu.ops import fused_conv as J
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.ops import fused_conv as T
from diffusion_image_editing_tpu_torch.ops.groupnorm import group_norm_reference
from tests.torch_port_helpers import jax_params, nchw, tiny_unet_params, tiny_vae_params

COEFF_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(seed, b=2, h=8, w=8, cin=16, cout=8, mean=0.0):
    """NHWC x, (cin,) scale and bias, HWIO kernel, (cout,) bias, (b, cin) shift."""
    rng = np.random.default_rng(seed)
    x = (mean + rng.standard_normal((b, h, w, cin))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    wk = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    cbias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    shift = (0.5 * rng.standard_normal((b, cin))).astype(np.float32)
    return x, scale, bias, wk, cbias, shift


def _oihw(wk):
    return torch.tensor(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("mean", [0.0, 50.0], ids=["mean0", "mean50"])
@pytest.mark.parametrize("use_shift", [False, True], ids=["noshift", "shift"])
def test_gn_affine_coeffs_match_jax(use_shift, mean):
    x, scale, bias, _, _, shift = _inputs(0, mean=mean)
    sh = shift if use_shift else None
    ja, jb = J.gn_affine_coeffs(jnp.asarray(x), scale, bias, 4, 1e-6, shift=sh)
    ta, tb = T.gn_affine_coeffs(_t(nchw(x)), _t(scale), _t(bias), 4, 1e-6,
                                shift=None if sh is None else _t(sh))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **COEFF_TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4 if mean else 1e-5)
    # x * A + B is GroupNorm(x + shift) * scale + bias, in the port alone.
    tx = _t(nchw(x))
    xs = tx if sh is None else tx + _t(sh)[:, :, None, None]
    want = group_norm_reference(xs, _t(scale), _t(bias), 4, 1e-6, act=None)
    got = tx * ta[:, :, None, None] + tb[:, :, None, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4 if mean else 2e-5)


@pytest.mark.parametrize(
    "b,h,w,cin,cout",
    [(2, 8, 8, 16, 8), (1, 16, 16, 32, 16), (2, 8, 12, 24, 16)],
)
def test_plain_fused_conv_matches_jax_and_pallas_interpret(b, h, w, cin, cout):
    x, scale, bias, wk, cbias, _ = _inputs(1, b, h, w, cin, cout)
    a, bb = J.gn_affine_coeffs(jnp.asarray(x), scale, bias, 4, 1e-6)
    want = J._jnp_fwd(jnp.asarray(x), a, bb, jnp.asarray(wk), jnp.asarray(cbias))
    plan = J._plan(x.shape, cin, cout, 4)
    pallas = J._pallas_fwd(jnp.asarray(x), a, bb, jnp.asarray(wk), jnp.asarray(cbias), plan,
                           interpret=True)
    got = T.affine_silu_conv3x3(_t(nchw(x)), _t(np.asarray(a)), _t(np.asarray(bb)), _oihw(wk),
                                _t(cbias))
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), nchw(pallas), **FWD_TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 8), (1, 6, 10, 24, 16)])
def test_fused_conv_gradients_match_jax(shape):
    b, h, w, cin, cout = shape
    x, scale, bias, wk, cbias, _ = _inputs(2, b, h, w, cin, cout)
    a, bb = (np.asarray(v) for v in J.gn_affine_coeffs(jnp.asarray(x), scale, bias, 4, 1e-6))
    cot = np.random.default_rng(3).standard_normal((b, h, w, cout)).astype(np.float32)

    def f(*args):
        return jnp.sum(J.affine_silu_conv3x3(*args) * cot)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(v) for v in (x, a, bb, wk, cbias)))
    leaves = [_t(nchw(x)), _t(a), _t(bb), _oihw(wk), _t(cbias)]
    for leaf in leaves:
        leaf.requires_grad_()
    y = T.affine_silu_conv3x3(*leaves)
    got = torch.autograd.grad((y * _t(nchw(cot))).sum(), leaves)
    np.testing.assert_allclose(got[0].numpy(), nchw(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **GRAD_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **GRAD_TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]).transpose(3, 2, 0, 1),
                               **GRAD_TOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), **GRAD_TOL)


@pytest.mark.parametrize("weights_need_grad", [False, True])
def test_weight_gradient_only_when_asked(monkeypatch, weights_need_grad):
    """The guidance gradient needs dx alone: dw runs only for a weight that
    requires a gradient (XLA's dead-code elimination in the JAX package)."""
    calls = []
    real = T._weight_grad
    monkeypatch.setattr(T, "_weight_grad", lambda *a: calls.append(1) or real(*a))
    x, scale, bias, wk, cbias, _ = _inputs(4)
    tx = _t(nchw(x)).requires_grad_()
    a, b = T.gn_affine_coeffs(tx, _t(scale), _t(bias), 4)
    w = _oihw(wk).requires_grad_(weights_need_grad)
    (dx,) = torch.autograd.grad(T.affine_silu_conv3x3(tx, a, b, w, _t(cbias)).sum(), tx)
    assert torch.isfinite(dx).all()
    assert len(calls) == int(weights_need_grad)


@pytest.mark.parametrize("cin,cout,with_temb", [(16, 16, True), (16, 24, True), (8, 16, False)])
def test_fused_resnet_block_matches_jax(monkeypatch, cin, cout, with_temb):
    """The JAX block under DIE_TPU_FUSED_CONV=1 (un-jitted, so the flag is
    read at this call) against the port's block with fused_conv=True; the
    temb projection folds into conv2's coefficients on both sides."""
    from diffusion_image_editing_tpu.models.layers import ResnetBlock2D as JBlock
    from diffusion_image_editing_tpu_torch.models.layers import ResnetBlock2D

    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    temb = rng.standard_normal((2, 12)).astype(np.float32) if with_temb else None
    jblock = JBlock(out_channels=cout, norm_num_groups=4)
    args = (jnp.asarray(x),) + ((jnp.asarray(temb),) if with_temb else ())
    params = jax_params(jblock, 5, *args)
    monkeypatch.setenv("DIE_TPU_FUSED_CONV", "1")
    want = jblock.apply(params, *args)
    block = ResnetBlock2D(cin, cout, 12 if with_temb else None, 4, fused_conv=True, device="cpu")
    block.load_state_dict(TM.state_dict_from_jax(params, "vae"))
    with torch.no_grad():
        got = block(_t(nchw(x)), None if temb is None else _t(temb))
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD_TOL)


@pytest.fixture(scope="module")
def tiny_pairs():
    """The port's tiny UNet and VAE, unfused and fused, with the same weights."""
    _, uparams = tiny_unet_params()
    _, vparams = tiny_vae_params()
    out = {}
    for fused in (False, True):
        unet = TM.UNet2DCondition(dataclasses.replace(TM.TINY_SD_UNET, fused_conv=fused),
                                  device="cpu")
        unet.load_state_dict(TM.state_dict_from_jax(uparams, "unet_cond"))
        vae = TM.AutoencoderKL(dataclasses.replace(TM.TINY_VAE, fused_conv=fused), device="cpu")
        vae.load_state_dict(TM.state_dict_from_jax(vparams, "vae"))
        out[fused] = (unet, vae)
    return out


def _resnet_blocks(module):
    from diffusion_image_editing_tpu_torch.models.layers import ResnetBlock2D

    blocks = [m for m in module.modules() if isinstance(m, ResnetBlock2D)]
    return len(blocks), sum(m.fused_conv for m in blocks)


def test_tiny_models_fused_match_unfused(tiny_pairs):
    """Every ResnetBlock of the tiny models takes the fused branch (all their
    stages are 4 to 64 pixels wide), and the outputs agree."""
    (unet, vae), (funet, fvae) = tiny_pairs[False], tiny_pairs[True]
    assert _resnet_blocks(unet) == (8, 0) and _resnet_blocks(vae) == (10, 0)
    assert _resnet_blocks(funet) == (8, 8) and _resnet_blocks(fvae) == (10, 10)
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = _t(rng.standard_normal((2, 7, 32)).astype(np.float32))
    img = _t(rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(funet(x, np.array([999, 1]), ctx).numpy(),
                                   unet(x, np.array([999, 1]), ctx).numpy(), **FWD_TOL)
        np.testing.assert_allclose(fvae.encode(img).numpy(), vae.encode(img).numpy(), **FWD_TOL)
    z = _t(rng.standard_normal((1, 4, 16, 16)).astype(np.float32)).requires_grad_()
    w = _t(rng.standard_normal((1, 3, 32, 32)).astype(np.float32))
    dec, fdec = vae.decode(z), fvae.decode(z)
    np.testing.assert_allclose(fdec.detach().numpy(), dec.detach().numpy(), **FWD_TOL)
    (g,) = torch.autograd.grad((dec * w).sum(), z)
    (fg,) = torch.autograd.grad((fdec * w).sum(), z)
    np.testing.assert_allclose(fg.numpy(), g.numpy(), **GRAD_TOL)


def test_tiny_vae_fused_decode_gradient_matches_jax_fused(monkeypatch, tiny_pairs):
    """The guidance gradient's path in both packages' fused configuration:
    d(sum(decode(z) * w))/dz, the JAX VAE un-jitted under DIE_TPU_FUSED_CONV=1."""
    jv, params = tiny_vae_params()
    _, fvae = tiny_pairs[True]
    rng = np.random.default_rng(10)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    monkeypatch.setenv("DIE_TPU_FUSED_CONV", "1")
    want = jax.grad(lambda z_: jnp.sum(jv.apply(params, z_, method="decode") * w))(jnp.asarray(z))
    tz = _t(nchw(z)).requires_grad_()
    (got,) = torch.autograd.grad((fvae.decode(tz) * _t(nchw(w))).sum(), tz)
    np.testing.assert_allclose(got.numpy(), nchw(want), **GRAD_TOL)


@pytest.mark.parametrize(
    "shape,wanted",
    [
        ((2, 320, 64, 64), True),    # the UNet's 64 x 64 stage (JAX's plan declines it)
        ((2, 2560, 8, 8), True),
        ((1, 512, 64, 64), True),    # the VAE's 64 x 64 stage
        ((1, 512, 128, 128), False),
        ((2, 320, 3, 64), False),
        ((2, 12, 8, 8), False),      # Cin % 8
    ],
)
def test_fused_conv_wanted(shape, wanted):
    assert T.fused_conv_wanted(shape) is wanted
    assert (T.shape_refused(shape, (16, shape[1], 3, 3)) is None) is wanted


def test_kernel_wrapper_refuses_cpu_tensors():
    x, scale, bias, wk, cbias, _ = _inputs(6)
    args = (_t(nchw(x)).bfloat16(), torch.ones(2, 16), torch.zeros(2, 16),
            _oihw(wk).bfloat16(), _t(cbias))
    before = OPS.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        T.affine_silu_conv3x3_kernel(*args)
    T.affine_silu_conv3x3(*args)
    assert OPS.launch_counts() == before


@pytest.mark.parametrize(
    "shape,splits",
    [
        ((2, 320, 320, 64, 64), 1),     # 64 pixel tiles x 2 cout tiles of 160: one wave
        ((2, 2560, 1280, 16, 16), 4),   # 32 tiles: 4 splits of 10 chunks, 128 blocks
        ((2, 2560, 1280, 8, 8), 14),    # 8 tiles: 14 splits of 3 chunks (the last of 1)
        ((2, 1280, 1280, 8, 8), 10),    # 8 tiles, 20 chunks: 10 splits of 2
        ((1, 512, 512, 64, 64), 1),     # the VAE's 64 x 64 stage, 32 x 4 tiles of 128
        ((2, 16, 24, 4, 4), 1),         # one chunk: nothing to split
        ((2, 1920, 640, 32, 32), 2),    # 64 tiles: a second wave would cost more than 2 splits
        ((20, 320, 320, 64, 64), 1),    # the batched inversion: ten waves as they are
    ],
)
def test_cin_splits(shape, splits):
    assert T.cin_splits(*shape) == splits
    chunks = -(-shape[1] // T.CHUNK_CIN)
    assert (splits - 1) * -(-chunks // splits) < chunks  # no split is empty


@pytest.mark.parametrize("cout,tile", [(320, 160), (640, 160), (1280, 160), (960, 160),
                                       (512, 128), (128, 128), (24, 128), (72, 128)])
def test_tile_cout(cout, tile):
    """The 160-wide tile where it pads Cout no more than the 128-wide one."""
    assert T.tile_cout(cout) == tile


@pytest.mark.parametrize("cout,cin", [(8, 16), (24, 72), (16, 64), (5, 8)])
def test_pack_weight_matches_numpy(cout, cin):
    """(Cout, Cin, 3, 3) -> (9, chunks, Cout, 64): a numpy transpose of the
    zero-padded weights gives tap ky * 3 + kx, chunk ci // 64, row co; within
    a row, the 16-byte piece p = (ci % 64) // 8 stands at place p ^ (co % 8)."""
    w = np.random.default_rng(cout).standard_normal((cout, cin, 3, 3)).astype(np.float32)
    got = T.pack_weight(_t(w))
    chunks = -(-cin // T.CHUNK_CIN)
    padded = np.pad(w.transpose(2, 3, 0, 1).reshape(9, cout, cin),
                    ((0, 0), (0, 0), (0, chunks * T.CHUNK_CIN - cin)))
    plain = padded.reshape(9, cout, chunks, 8, 8).transpose(0, 2, 1, 3, 4)  # unswizzled
    want = np.empty_like(plain)
    for co in range(cout):
        for place in range(8):
            want[:, :, co, place] = plain[:, :, co, place ^ (co % 8)]
    assert got.is_contiguous() and got.shape == (9, chunks, cout, T.CHUNK_CIN)
    np.testing.assert_array_equal(got.numpy(), want.reshape(9, chunks, cout, T.CHUNK_CIN))


def test_packed_weight_cache_follows_the_weight():
    """One packing per weight tensor and version: an in-place change or a
    new tensor packs anew, and an entry goes with its tensor."""
    w = torch.nn.Parameter(_t(np.random.default_rng(0).standard_normal((8, 16, 3, 3))
                               .astype(np.float32)))
    entries, misses, hits = len(T._PACKED), T.packed_weight.misses, T.packed_weight.hits
    first = T.packed_weight(w)
    assert T.packed_weight(w) is first
    assert (T.packed_weight.misses, T.packed_weight.hits) == (misses + 1, hits + 1)
    with torch.no_grad():
        w.add_(1.0)  # what an optimizer step or load_state_dict does
    second = T.packed_weight(w)
    assert second is not first and T.packed_weight.misses == misses + 2
    torch.testing.assert_close(second, T.pack_weight(w), rtol=0, atol=0)
    pieces = [p ^ (co % 8) for co in range(8) for p in (0, 1)]  # where the 16 channels stand
    real = second.reshape(9, 1, 8, 8, 8)[:, :, np.repeat(np.arange(8), 2), pieces]
    torch.testing.assert_close(real, first.reshape(9, 1, 8, 8, 8)[
        :, :, np.repeat(np.arange(8), 2), pieces] + 1.0)
    other = w.detach().clone()  # a new tensor with the same values
    assert T.packed_weight(other) is not second and T.packed_weight.misses == misses + 3
    assert len(T._PACKED) == entries + 2 and T.packed_weight_bytes() >= 2 * second.numel() * 4
    del w, other
    assert len(T._PACKED) == entries
