"""The port's `ops/resize.py` against the JAX package's, same inputs (numpy,
seeded), NCHW against NHWC.

Tolerances: the bilinear resize atol 1e-6 on [0, 1] inputs (f32 sums of the
same weights in another order; readings up to 5.7e-7); the nearest resize,
the hard mask at the path's power-of-two factors and the element-wise maps
exactly or within 1e-6 as stated in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_image_editing_tpu.ops import resize as J
from diffusion_image_editing_tpu_torch.ops import resize as T

BILINEAR = dict(rtol=0, atol=1e-6)
SIZES = [(64, 64, 16, 16), (512, 512, 64, 64), (30, 30, 16, 16), (50, 40, 20, 30),
         (37, 100, 100, 37), (32, 48, 64, 80), (16, 16, 64, 64)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("h0,w0,h,w", SIZES)
def test_resize_bilinear_and_nearest_match_jax(h0, w0, h, w):
    x = np.random.default_rng(h0 + w).uniform(0, 1, (2, h0, w0, 3)).astype(np.float32)
    got = T.resize_bilinear(_nchw(x), h, w)
    want = J.resize_bilinear(jnp.asarray(x), h, w)
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), **BILINEAR)
    np.testing.assert_array_equal(_nhwc(T.resize_nearest(_nchw(x), h, w).numpy()),
                                  np.asarray(J.resize_nearest(jnp.asarray(x), h, w)))


def _blob_masks(size, seed):
    """Discs of random centre and radius (several reach the border); one in
    three adds a second disc, so that overlaps reach 2."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for i in range(6):
        cy, cx = rng.uniform(0, size, 2)
        r = rng.uniform(size / 8, size / 1.5)
        m = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)
        if i % 3 == 0:
            m += ((yy - cx) ** 2 + (xx - cy) ** 2) < r * r / 2
        yield m


@pytest.mark.parametrize("size,out", [(512, 64), (64, 16), (64, 32), (256, 32), (32, 16)])
def test_hard_mask_is_bit_equal_to_jax(size, out):
    """The mask's resize at power-of-two factors, 512 -> 64 (image to SD
    latent) among them: bit-equal, and the antialiasing matters (without
    it, pixels differ)."""
    differs = 0
    for m in _blob_masks(size, size + out):
        want = np.asarray(J.resize_mask_hard(jnp.asarray(m[None, ..., None]), out, out))[0, ..., 0]
        got = T.resize_mask_hard(torch.from_numpy(m)[None, None], out, out)[0, 0]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        plain = F.interpolate(torch.from_numpy(m)[None, None], size=(out, out), mode="bilinear",
                              align_corners=False)[0, 0]
        differs += int(((plain >= 1.0).float().numpy() != want).sum())
    assert differs > 0


def test_hard_mask_keeps_a_footprint_of_ones_at_any_factor():
    """A pixel whose whole footprint is 1 survives at any factor: the resize
    runs in f64, so no summation order lands it below 1.0 (the JAX
    package's f32 resize drops 400 of 1369 such pixels at 100 -> 37)."""
    for size, out in ((100, 37), (30, 16), (64, 16), (37, 100)):
        mask = T.resize_mask_hard(torch.ones(1, 1, size, size), out, out)
        assert torch.equal(mask, torch.ones(1, 1, out, out))
    assert T.resize_mask_hard(torch.ones(1, 1, 8, 8, dtype=torch.float64), 4, 4).dtype == \
        torch.float64


def test_normalisation_and_ranges_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.3, 1.3, (2, 9, 7, 3)).astype(np.float32)
    x01 = rng.uniform(0, 1, (2, 9, 7, 3)).astype(np.float32)
    for port, jax_fn, arg in ((T.to_unit_range, J.to_unit_range, x),
                              (T.to_symmetric_range, J.to_symmetric_range, x01),
                              (T.imagenet_normalize, J.imagenet_normalize, x01)):
        np.testing.assert_allclose(_nhwc(port(_nchw(arg)).numpy()),
                                   np.asarray(jax_fn(jnp.asarray(arg))), rtol=0, atol=1e-6)
    unit = T.to_unit_range(_nchw(x))
    assert float(unit.min()) == 0.0 and float(unit.max()) == 1.0  # clipped
