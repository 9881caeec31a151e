"""The port's `seg/evaluate.py` against the JAX package's: the parsing
overlay, mIoU and pixel accuracy, the unsharp mask and the HSV recolouring
(numpy and PIL on both sides: equal to the pixel and to the float), and
`evaluate_dir` over a directory with the port's `SegmentationModel` and a
test double of the parsing (both packages' overlays written, file for
file equal)."""

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_image_editing_tpu.seg import evaluate as JE
from diffusion_image_editing_tpu_torch.models import BiSeNet, SegmentationModel
from diffusion_image_editing_tpu_torch.seg import evaluate as TE


def _case(seed=0, size=32, classes=19):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    pred = rng.integers(0, classes, (size, size))
    label = np.where(rng.uniform(size=(size, size)) < 0.7, pred,
                     rng.integers(0, classes, (size, size)))
    label[:2] = 255  # ignored
    return img, pred, label


def test_overlay_and_metrics_match_jax(tmp_path):
    img, pred, label = _case()
    path = str(tmp_path / "vis.png")
    got = TE.vis_parsing_maps(img, pred, alpha=0.4, save_path=path)
    np.testing.assert_array_equal(got, JE.vis_parsing_maps(img, pred, alpha=0.4))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), got)
    for n in (19, 4):
        assert TE.segmentation_metrics(pred, label, n) == JE.segmentation_metrics(pred, label, n)
    perfect = TE.segmentation_metrics(pred, pred, 19)
    assert perfect == {"pixel_acc": 1.0, "miou": 1.0}
    assert TE.segmentation_metrics(pred, np.full_like(pred, 255)) == {"pixel_acc": 0.0,
                                                                      "miou": 0.0}


@pytest.mark.parametrize("part,color", [(17, (230, 50, 20)), (12, (200, 20, 60)),
                                        (2, (255, 0, 0))], ids=["hair", "lip", "brow"])
def test_makeup_matches_jax(part, color):
    img, pred, _ = _case(seed=1, size=40)
    np.testing.assert_array_equal(TE.sharpen(img), JE.sharpen(img))
    got = TE.recolor_part(img, pred, part=part, color=color)
    np.testing.assert_array_equal(got, JE.recolor_part(img, pred, part=part, color=color))
    changed = np.any(got != img, axis=-1)
    assert changed[pred == part].any() and not changed[pred != part].any()


def test_evaluate_dir_matches_jax(tmp_path):
    """Each image resized to 512, parsed, its overlay saved under its name;
    the parsing is a test double given the same map on both sides, and the
    port's `SegmentationModel` (a width-8 BiSeNet) writes a map of the
    image's 512 x 512 shape."""
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(2)
    for name in ("b.png", "a.png"):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(src / name)
    parsing = rng.integers(0, 19, (512, 512))
    seen = []

    def t_seg(x):
        seen.append(tuple(x.shape))
        return torch.from_numpy(parsing)

    TE.evaluate_dir(t_seg, str(src), str(tmp_path / "port"))
    JE.evaluate_dir(lambda x: parsing, str(src), str(tmp_path / "jax"))
    assert seen == [(1, 3, 512, 512)] * 2
    for name in ("a.png", "b.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))
    torch.manual_seed(0)
    seg = SegmentationModel(BiSeNet(width=8, device="cpu"))
    TE.evaluate_dir(seg, str(src), str(tmp_path / "bisenet"))
    assert np.asarray(Image.open(tmp_path / "bisenet" / "a.png")).shape == (512, 512, 3)
