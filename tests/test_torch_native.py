"""The port's native host ops (`ops/native/`) against the JAX package's: the
same g++ source and flags, so the libraries agree bit for bit, and so do the
numpy versions beside them; the library against its numpy version as the
JAX package's own tests hold them (tests/test_native.py)."""

import numpy as np
import pytest

from diffusion_image_editing_tpu.ops import native as J
from diffusion_image_editing_tpu.seg import merge_part_masks
from diffusion_image_editing_tpu.seg.data import CELEBA_PART_NAMES
from diffusion_image_editing_tpu_torch.ops import native as T


def _jax_numpy(monkeypatch, fn, *args):
    """The JAX package's numpy version of `fn` (its library set aside)."""
    J.host_lib()
    monkeypatch.setitem(J._LIBS, "host_ops", None)
    return fn(*args)


def test_the_library_builds_into_the_ignored_build_directory():
    assert T.host_lib() is not None, "g++ expected on this machine"
    assert T.library_path().parent.name == ".build" and T.library_path().exists()


def test_merge_part_masks(monkeypatch):
    rng = np.random.default_rng(0)
    parts = (rng.random((18, 64, 64)) > 0.9).astype(np.uint8) * 225
    out = T.merge_part_masks_native(parts)
    ref = merge_part_masks({att: parts[i] for i, att in enumerate(CELEBA_PART_NAMES)}, size=64)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, J.merge_part_masks_native(parts))
    np.testing.assert_array_equal(T.merge_part_masks_numpy(parts),
                                  _jax_numpy(monkeypatch, J.merge_part_masks_native, parts))


@pytest.mark.parametrize("size", [(16, 24), (45, 70)])
def test_resize_bilinear_u8(monkeypatch, size):
    img = np.random.default_rng(1).integers(0, 255, (32, 48, 3), np.uint8)
    fast = T.resize_bilinear_u8(img, *size)
    np.testing.assert_array_equal(fast, J.resize_bilinear_u8(img, *size))
    slow = T.resize_bilinear_u8_numpy(img, *size)
    np.testing.assert_array_equal(slow, _jax_numpy(monkeypatch, J.resize_bilinear_u8, img, *size))
    assert fast.shape == slow.shape == size + (3,)
    assert np.mean(np.abs(fast.astype(int) - slow.astype(int))) < 1.0


def test_normalize_imagenet(monkeypatch):
    img = np.random.default_rng(2).integers(0, 255, (8, 8, 3), np.uint8)
    out = T.normalize_imagenet(img)
    np.testing.assert_array_equal(out, J.normalize_imagenet(img))
    ref = T.normalize_imagenet_numpy(img)
    np.testing.assert_array_equal(ref, _jax_numpy(monkeypatch, J.normalize_imagenet, img))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_to_symmetric_range(monkeypatch):
    img = np.arange(0, 256, dtype=np.uint8).reshape(16, 16)
    out = T.to_symmetric_range(img)
    np.testing.assert_array_equal(out, J.to_symmetric_range(img))
    ref = T.to_symmetric_range_numpy(img)
    np.testing.assert_array_equal(ref, _jax_numpy(monkeypatch, J.to_symmetric_range, img))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_without_a_toolchain_the_numpy_versions_run(monkeypatch):
    monkeypatch.setitem(T._LIBS, "host_ops", None)
    img = np.random.default_rng(3).integers(0, 255, (10, 12, 3), np.uint8)
    np.testing.assert_array_equal(T.resize_bilinear_u8(img, 5, 6),
                                  T.resize_bilinear_u8_numpy(img, 5, 6))
    np.testing.assert_array_equal(T.to_symmetric_range(img), T.to_symmetric_range_numpy(img))
