"""The port's LPIPS (`evals/lpips.py`) against the JAX package's, with the
same weights: carried from seeded Flax params by `state_dict_from_jax(...,
"lpips")`, and read from torchvision / lpips-named state dicts by the port's
`port_vgg16_lpips` beside the JAX package's. f32 on both sides.

Tolerances: the VGG16 taps rtol 1e-4, atol 1e-5 (thirteen convs of f32
sums in another order); the distances rtol 1e-4, atol 1e-6; the input
gradient rtol 1e-3, atol 1e-6 (through the unit normalisation's rsqrt)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.evals import lpips as JL
from diffusion_image_editing_tpu_torch.evals import LPIPS, VGG16Features, make_lpips_fn
from diffusion_image_editing_tpu_torch.evals.lpips import conv_positions
from diffusion_image_editing_tpu_torch.models import port as P
from tests.torch_port_helpers import jax_params, nchw

FEAT = dict(rtol=1e-4, atol=1e-5)
DIST = dict(rtol=1e-4, atol=1e-6)
GRAD = dict(rtol=1e-3, atol=1e-6)
WIDTH = 0.125


def _pair(width=WIDTH, use_lin=True, seed=0, size=32):
    """(JAX LPIPS, its params, the port's LPIPS with the same weights)."""
    jm = JL.LPIPS(width_mult=width, use_lin=use_lin)
    x = jnp.zeros((1, size, size, 3))
    params = jax_params(jm, seed, x, x)
    if use_lin:  # non-negative heads of unequal weights, as the released ones
        rng = np.random.default_rng(seed + 50)
        for i in range(5):
            c = params["params"][f"lin_{i}"].shape[0]
            params["params"][f"lin_{i}"] = rng.uniform(0.0, 2.0 / c, c).astype(np.float32)
    tm = LPIPS(width, use_lin=use_lin, device="cpu")
    tm.load_state_dict(P.state_dict_from_jax(params, "lpips"), strict=use_lin)
    return jm, params, tm


def _images(n=2, size=32, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32))


def test_vgg16_taps_match_jax():
    jm, params, tm = _pair()
    a, _ = _images()
    jtaps = JL.VGG16Features(WIDTH).apply({"params": params["params"]["vgg"]}, jnp.asarray(a))
    ttaps = tm.vgg(torch.from_numpy(nchw(a)))
    assert len(ttaps) == 5
    for j, t in zip(jtaps, ttaps):
        np.testing.assert_allclose(t.numpy(), nchw(j), **FEAT)
    assert isinstance(tm.vgg, VGG16Features)


@pytest.mark.parametrize("use_lin", [True, False], ids=["lin", "mean"])
def test_lpips_matches_jax(use_lin):
    jm, params, tm = _pair(use_lin=use_lin)
    a, b = _images()
    ref = jm.apply(params, jnp.asarray(a), jnp.asarray(b))
    got = tm(torch.from_numpy(nchw(a)), torch.from_numpy(nchw(b)))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIST)


def test_lpips_is_a_distance_and_takes_3_dim_inputs():
    _, _, tm = _pair()
    fn = make_lpips_fn(tm)
    a, b = (torch.from_numpy(nchw(x)) for x in _images())
    assert fn(a, a).abs().max().item() < 1e-6
    torch.testing.assert_close(fn(a, b), fn(b, a), rtol=1e-5, atol=0)
    one = fn(a[0], b[0])  # (C, H, W) -> a batch of one
    assert one.shape == (1,)
    torch.testing.assert_close(one, fn(a, b)[:1], rtol=1e-6, atol=1e-7)
    assert (fn(a, b) > 0).all()


def test_lpips_input_gradient_matches_jax():
    """The gradient LPIPS guidance takes (`AttrFunc.metric="lpips"`)."""
    jm, params, tm = _pair()
    a, b = _images()
    jfn = JL.make_lpips_fn(params, width_mult=WIDTH)
    ref = jax.grad(lambda x: jnp.sum(jfn(x, jnp.asarray(b))))(jnp.asarray(a))
    x = torch.from_numpy(nchw(a)).requires_grad_(True)
    (got,) = torch.autograd.grad(make_lpips_fn(tm)(x, torch.from_numpy(nchw(b))).sum(), x)
    np.testing.assert_allclose(got.numpy(), nchw(ref), **GRAD)


def _torchvision_dicts(width_mult, seed=3):
    """A torchvision-named VGG16 state dict (with its classifier, as the
    published file) and lpips' lin heads, from numpy."""
    rng = np.random.default_rng(seed)
    vgg, cin = {}, 3
    chans = [v for v in JL._VGG16_CFG if v != "M"]
    for p, v in zip(conv_positions(), chans):
        c = max(int(v * width_mult), 1)
        vgg[f"features.{p}.weight"] = torch.from_numpy(
            (rng.standard_normal((c, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
        vgg[f"features.{p}.bias"] = torch.from_numpy(
            (0.02 * rng.standard_normal(c)).astype(np.float32))
        cin = c
    vgg["classifier.0.weight"] = torch.zeros(4, 4)
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.05, (1, max(int(c * width_mult), 1), 1, 1)).astype(np.float32))
        for i, c in enumerate(JL._TAP_CHANNELS)}
    return vgg, lins


@pytest.mark.parametrize("width,with_lins", [(WIDTH, True), (1.0, False)],
                         ids=["narrow-lins", "full-default-heads"])
def test_torchvision_and_lpips_names_load_as_the_jax_port_reads_them(width, with_lins):
    """The published files' names: the port's `port_vgg16_lpips` and a plain
    `load_state_dict` against the JAX package's `port_vgg16_lpips`; without
    lin heads every channel weighs 1/C in both."""
    vgg, lins = _torchvision_dicts(width)
    lins = lins if with_lins else None
    np_vgg = {k: v.numpy() for k, v in vgg.items()}
    np_lins = None if lins is None else {k: v.numpy() for k, v in lins.items()}
    jparams = jax.tree.map(jnp.asarray, JL.port_vgg16_lpips(np_vgg, np_lins))
    tm = LPIPS(width, device="cpu")
    tm.load_state_dict(P.port_vgg16_lpips(vgg, lins))
    if with_lins:  # the lpips file alone loads by name, beside the VGG's features
        tm.load_state_dict(lins, strict=False)
    size = 16
    a, b = _images(size=size, seed=4)
    ref = JL.make_lpips_fn(jparams, width_mult=width)(jnp.asarray(a), jnp.asarray(b))
    got = make_lpips_fn(tm)(torch.from_numpy(nchw(a)), torch.from_numpy(nchw(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIST)
    heads = [tm.get_submodule(f"lin{i}").model[1].weight for i in range(5)]
    if not with_lins:
        assert all(torch.allclose(h, torch.full_like(h, 1.0 / h.shape[1])) for h in heads)


def test_default_heads_and_device():
    tm = LPIPS(WIDTH, device="cpu")
    assert not tm.training and not any(p.requires_grad for p in tm.parameters())
    keys = set(tm.state_dict())
    assert "vgg.features.0.weight" in keys and "vgg.features.28.bias" in keys
    assert {f"lin{i}.model.1.weight" for i in range(5)} <= keys
    assert not any(k in keys for k in ("shift", "scale"))
    w = tm.lin1.model[1].weight
    torch.testing.assert_close(w, torch.full_like(w, 1.0 / w.shape[1]))
