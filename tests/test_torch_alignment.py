"""The port's host-side helpers against the JAX package's: face alignment
(`host/alignment.py`: the quad, landmarks from a parsing map, the staged
FFHQ warp on the golden cases of tests/test_host_align_tok.py and the
parsing-driven alignment of `edit --align`) and plotting
(`host/plotting.py`). Both are numpy / scipy / PIL code on both sides, so
the images are held pixel-equal and the geometry to 1e-12."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_image_editing_tpu.host import alignment as JA
from diffusion_image_editing_tpu.host import plotting as JP
from diffusion_image_editing_tpu_torch.host import alignment as TA
from diffusion_image_editing_tpu_torch.host import plotting as TP

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "align_golden.npz")


def face_parsing(size=256):
    """Eyes and a mouth (with lips) on a parsing map."""
    parsing = np.zeros((size, size), np.int32)
    s = size / 256
    parsing[int(95 * s):int(105 * s), int(95 * s):int(105 * s)] = 4
    parsing[int(95 * s):int(105 * s), int(155 * s):int(165 * s)] = 5
    parsing[int(165 * s):int(175 * s), int(105 * s):int(155 * s)] = 11
    parsing[int(160 * s):int(165 * s), int(110 * s):int(150 * s)] = 12
    parsing[int(175 * s):int(180 * s), int(110 * s):int(150 * s)] = 13
    return parsing


def _photo(h=384, w=512, seed=0):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                                dtype=np.uint8))


def test_quad_and_parsing_landmarks_match_jax():
    parsing = face_parsing()
    lm = TA.landmarks_from_parsing(parsing)
    np.testing.assert_array_equal(lm, JA.landmarks_from_parsing(parsing))
    for got, ref in zip(TA.align_quad(lm), JA.align_quad(lm)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    no_mouth = np.where(np.isin(parsing, (11, 12, 13)), 0, parsing)
    for bad, what in ((np.zeros((16, 16), np.int32), "class 4"), (no_mouth, "mouth")):
        with pytest.raises(ValueError, match=what):
            TA.landmarks_from_parsing(bad)


def test_align_face_golden_cases_match_jax():
    """Shrink, crop, the feathered reflect-pad and the no-padding path."""
    data = np.load(GOLDEN)
    img = Image.fromarray(data["img"], "RGB")
    cases = [(img, data["lm"], dict(output_size=64, transform_size=128), data["out"]),
             (img, data["lm"], dict(output_size=64, transform_size=64, enable_padding=False),
              data["out2"]),
             (img.resize((704, 704), Image.LANCZOS), data["lm_big"],
              dict(output_size=32, transform_size=32), data["out3"])]
    for im, lm, kw, golden in cases:
        got = np.asarray(TA.align_face(im, landmarks=lm, **kw))
        np.testing.assert_array_equal(got, np.asarray(JA.align_face(im, landmarks=lm, **kw)))
        np.testing.assert_array_equal(got, golden)


def test_align_from_parsing_and_prepare_match_jax(tmp_path):
    """`edit --align` without `--landmarks`: the parsing map's landmarks
    rescaled from its frame to the image's, then the warp; and the aligned
    image as a tensor in [-1, 1]."""
    img = _photo()
    parsing = face_parsing()
    got = TA.align_from_parsing(img, parsing, output_size=64)
    assert got.size == (64, 64)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(JA.align_from_parsing(img, parsing, output_size=64)))
    path = str(tmp_path / "face.png")
    img.save(path)
    lm = TA.landmarks_from_parsing(parsing) * 1.5
    t = TA.prepare_real_image_for_editing(path, landmarks=lm, output_size=32)
    j = JA.prepare_real_image_for_editing(path, landmarks=lm, output_size=32)
    assert t.shape == (1, 3, 32, 32) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), j.transpose(0, 3, 1, 2))
    t2 = TA.prepare_real_image_for_editing(path, landmark_fn=lambda a: lm, output_size=32)
    torch.testing.assert_close(t2, t, rtol=0, atol=0)
    with pytest.raises(ValueError, match="landmark"):
        TA.align_face(img)


def test_dlib_landmarker_needs_dlib(monkeypatch):
    """dlib is imported when the landmarker is made, not with the module."""
    import sys

    monkeypatch.setitem(sys.modules, "dlib", None)
    with pytest.raises(ImportError):
        TA.dlib_landmarker("shape_predictor_68_face_landmarks.dat")


def _img(v):
    return Image.new("RGB", (8, 8), (v, v, v))


def test_strips_match_jax():
    imgs = [_img(10), Image.new("RGB", (10, 9), (20, 40, 60)), _img(30)]
    for axis in (0, 1):
        np.testing.assert_array_equal(np.asarray(TP.concat_images(imgs, axis)),
                                      np.asarray(JP.concat_images(imgs, axis)))
    got = TP.add_source_image(_img(0), [_img(50), _img(100)])
    assert got.size == (24, 8)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(JP.add_source_image(_img(0), [_img(50), _img(100)])))


def test_grids_match_jax():
    """The grid's figure as drawn by both, and samples given as tensors
    (the port's NCHW layout) or PIL images."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    figs = [TP.display_samples([torch.from_numpy(x[0]), torch.from_numpy(x[1:]), _img(30)],
                               num_cols=2, row_labels=["scale=1", "scale=2"], title="sweep"),
            JP.display_samples([x[0].transpose(1, 2, 0), x[1].transpose(1, 2, 0), _img(30)],
                               num_cols=2, row_labels=["scale=1", "scale=2"], title="sweep")]
    pixels = []
    for fig in figs:
        fig.canvas.draw()
        pixels.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)
    np.testing.assert_array_equal(pixels[0], pixels[1])
    assert len(figs[0].axes) == 4 and figs[0].axes[0].get_title() == "scale=1"
    grid = TP.show_images_in_a_grid([_img(i * 20) for i in range(5)], num_cols=3)
    assert len(grid.axes) == 6
    plt.close(grid)

