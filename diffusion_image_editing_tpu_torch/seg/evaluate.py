"""Segmentation evaluation and visualisation: the port's own copy of the
JAX package's `seg/evaluate.py`. Parsing-map colour overlays, a directory
evaluation, an HSV-recolouring makeup demo (PIL and numpy, host-side), and
mIoU / pixel accuracy. PIL is imported when a function needs it, not with
the module.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np

# Colours of the parts
PART_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 0, 85], [255, 0, 170],
    [0, 255, 0], [85, 255, 0], [170, 255, 0], [0, 255, 85], [0, 255, 170],
    [0, 0, 255], [85, 0, 255], [170, 0, 255], [0, 85, 255], [0, 170, 255],
    [255, 255, 0], [255, 255, 85], [255, 255, 170], [255, 0, 255],
    [255, 85, 255], [255, 170, 255], [0, 255, 255], [85, 255, 255],
    [170, 255, 255],
]


def vis_parsing_maps(
    im, parsing: np.ndarray, alpha: float = 0.6, save_path: Optional[str] = None
) -> np.ndarray:
    """Colour overlay of a parsing map on an image."""
    im = np.asarray(im).astype(np.float32)
    color = np.full(parsing.shape + (3,), 255.0, np.float32)
    for pi in range(1, int(parsing.max()) + 1):
        color[parsing == pi] = PART_COLORS[pi]
    vis = (1 - alpha) * im + alpha * color
    vis = np.clip(vis, 0, 255).astype(np.uint8)
    if save_path:
        from PIL import Image

        Image.fromarray(vis).save(save_path)
    return vis


def evaluate_dir(segmentation_model, image_dir: str, out_dir: str) -> None:
    """Run the segmentation model (a `models.SegmentationModel`: a (1, 3, H,
    W) image in [-1, 1] -> an (H, W) parsing map) over a directory at 512
    px and save each image's overlay under the same name."""
    from PIL import Image

    from ..host.transforms import pil_to_tensor

    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(image_dir)):
        img = Image.open(osp.join(image_dir, name)).convert("RGB")
        img512 = img.resize((512, 512), Image.BILINEAR)
        parsing = segmentation_model(pil_to_tensor(img512)).cpu().numpy()
        vis_parsing_maps(img512, parsing, save_path=osp.join(out_dir, name))


def segmentation_metrics(
    pred: np.ndarray, label: np.ndarray, n_classes: int = 19, ignore: int = 255
) -> Dict[str, float]:
    """mIoU + pixel accuracy."""
    valid = label != ignore
    p, l = pred[valid], label[valid]
    acc = float((p == l).mean()) if p.size else 0.0
    ious = []
    for c in range(n_classes):
        inter = np.logical_and(p == c, l == c).sum()
        union = np.logical_or(p == c, l == c).sum()
        if union > 0:
            ious.append(inter / union)
    return {"pixel_acc": acc, "miou": float(np.mean(ious)) if ious else 0.0}


# ---------------------------------------------------------------------------
# Makeup demo, PIL / numpy
# ---------------------------------------------------------------------------


def _rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(arr, "RGB").convert("HSV"))


def _hsv_to_rgb(arr: np.ndarray) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(arr, "HSV").convert("RGB"))


def sharpen(img: np.ndarray, sigma: float = 5.0, alpha: float = 1.5) -> np.ndarray:
    """Unsharp mask."""
    from PIL import Image, ImageFilter

    pil = Image.fromarray(img.astype(np.uint8))
    blurred = np.asarray(pil.filter(ImageFilter.GaussianBlur(sigma)), np.float32)
    out = (img.astype(np.float32) - blurred) * alpha + img.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def recolor_part(
    image: np.ndarray,
    parsing: np.ndarray,
    part: int = 17,
    color: Sequence[int] = (230, 50, 20),
) -> np.ndarray:
    """HSV recolouring of one parsing class: copy the target colour's hue
    (hue + saturation for the lips) into the region; the hair is sharpened
    too. RGB in and out."""
    image = image.astype(np.uint8)
    tar = np.zeros_like(image)
    tar[..., 0], tar[..., 1], tar[..., 2] = color
    img_hsv = _rgb_to_hsv(image).copy()
    tar_hsv = _rgb_to_hsv(tar)
    if part in (12, 13):  # lips: hue + saturation
        img_hsv[..., 0:2] = tar_hsv[..., 0:2]
    else:
        img_hsv[..., 0:1] = tar_hsv[..., 0:1]
    changed = _hsv_to_rgb(img_hsv)
    if part == 17:  # hair gets sharpened
        changed = sharpen(changed)
    out = image.copy()
    region = parsing == part
    out[region] = changed[region]
    return out
