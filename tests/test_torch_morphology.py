"""The port's `ops/morphology.py` against the JAX package's, same inputs
(numpy, seeded), NCHW against NHWC.

Tolerances: flat dilation and erosion, and hard weighted morphology, exactly
(a max or min of the same f32 sums); the soft-max relaxation 1e-5 (a
logsumexp summed in another order, scaled by beta = 15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.ops import morphology as J
from diffusion_image_editing_tpu_torch.ops import morphology as T

SOFT = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _input(dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal((2, 11, 9, 3)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), (2, 11, 9, 3), dtype=dtype)


@pytest.mark.parametrize("k", [3, 4, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dilate_and_erode_match_jax(k, dtype):
    """Odd and even kernels (the even one pads one more pixel after than
    before), float and integer inputs, exactly; a binary mask too."""
    x = _input(dtype, k)
    for port, ref in ((T.dilate, J.dilate), (T.erode, J.erode)):
        got = port(_nchw(x), k)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(_nhwc(got), np.asarray(ref(jnp.asarray(x), k)))
    mask = (x > np.median(x)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(T.dilate(_nchw(mask), k)),
                                  np.asarray(J.dilate(jnp.asarray(mask), k)))


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("op", ["dilation2d", "erosion2d"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_morphology2d_matches_jax(k, op, soft):
    rng = np.random.default_rng(k + 10 * soft)
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 3, k, k))).astype(np.float32)
    for weight in (w, None):
        ref = J.morphology2d(jnp.asarray(x), None if weight is None else jnp.asarray(weight), k,
                             op, soft, 15.0)
        got = T.morphology2d(_nchw(x), None if weight is None else torch.from_numpy(weight), k,
                             op, soft, 15.0)
        assert tuple(got.shape) == (2, 1 if weight is None else 4, 8, 10)
        if soft:
            np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **SOFT)
        else:
            np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    with pytest.raises(ValueError):
        T.morphology2d(_nchw(x), None, k, "opening")


@pytest.mark.parametrize("cls", ["Dilation2D", "Erosion2D"])
def test_morphology_layers_with_ported_weights(cls):
    """The Flax layer's `weight` param is already (O, C, k, k): it loads as
    the module's state dict; the layers start flat (zero weights)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 9, 9, 2)).astype(np.float32)
    jm = getattr(J, cls)(in_channels=2, out_channels=3, kernel_size=5)
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]["weight"]
    w = (0.2 * rng.standard_normal(shape.shape)).astype(np.float32)
    tm = getattr(T, cls)(in_channels=2, out_channels=3, kernel_size=5)
    assert not tm.weight.any() and tm.op == jm.op
    tm.load_state_dict({"weight": torch.from_numpy(w)}, strict=True)
    want = jm.apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(want), **SOFT)
    grads = torch.autograd.grad(tm(_nchw(x)).sum(), tm.weight)[0]
    assert torch.isfinite(grads).all() and grads.abs().sum() > 0  # trainable
