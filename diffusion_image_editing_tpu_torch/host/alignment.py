"""FFHQ-style face alignment, host-side: the port's own copy of the JAX
package's `host/alignment.py` (numpy, scipy and PIL; the images are PIL and
numpy, so the two compute alike).

68-landmark geometry -> oriented quad -> shrink / crop / reflect-pad + blur
-> QUAD warp to the target resolution. The landmark detector is pluggable:
dlib when installed, or any callable returning a (68, 2) array;
`landmarks_from_parsing` derives the eye and mouth anchor points from a
BiSeNet parsing map, so no dlib is needed. PIL, scipy and dlib are imported
when a function needs them, not with the module.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

LandmarkFn = Callable[[np.ndarray], np.ndarray]  # RGB uint8 HWC -> (68, 2)


def dlib_landmarker(predictor_path: str) -> LandmarkFn:
    """dlib's 68-landmark detector; requires dlib."""
    import dlib  # optional dependency

    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)

    def fn(img: np.ndarray) -> np.ndarray:
        dets = detector(img, 1)
        if len(dets) == 0:
            raise ValueError("no face detected")
        shape = predictor(img, dets[-1])
        return np.array([[p.x, p.y] for p in shape.parts()])

    return fn


# CelebAMask-HQ class ids (utils/constants.py)
_L_EYE, _R_EYE, _MOUTH, _U_LIP, _L_LIP = 4, 5, 11, 12, 13


def landmarks_from_parsing(parsing: np.ndarray) -> np.ndarray:
    """Derive the alignment anchor points from a face-parsing map.

    `align_quad` only consumes mean(eye_left), mean(eye_right), and the outer
    mouth corners, so a synthetic 68-point array carrying those in the right
    slots reproduces the crop geometry without dlib."""

    def centroid(cls):
        ys, xs = np.nonzero(parsing == cls)
        if len(xs) == 0:
            raise ValueError(f"class {cls} absent from parsing map")
        return np.array([xs.mean(), ys.mean()])

    eye_l = centroid(_L_EYE)
    eye_r = centroid(_R_EYE)
    mouth = np.nonzero(np.isin(parsing, (_MOUTH, _U_LIP, _L_LIP)))
    if len(mouth[0]) == 0:
        raise ValueError("mouth absent from parsing map")
    mxs, mys = mouth[1], mouth[0]
    mouth_left = np.array([mxs.min(), mys[np.argmin(mxs)]])
    mouth_right = np.array([mxs.max(), mys[np.argmax(mxs)]])

    lm = np.zeros((68, 2))
    lm[36:42] = eye_l
    lm[42:48] = eye_r
    lm[48] = mouth_left
    lm[54] = mouth_right
    return lm


def align_quad(lm: np.ndarray):
    """Oriented crop rectangle from landmarks."""
    eye_left = np.mean(lm[36:42], axis=0)
    eye_right = np.mean(lm[42:48], axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    return quad, qsize


# FFHQ geometry constants (the NVlabs FFHQ recipe): the output-parity
# contract with the JAX package.
_BORDER_FRAC = 0.1  # crop border as a fraction of qsize (min 3 px)
_PAD_FRAC = 0.3  # minimum reflect-pad extent as a fraction of qsize
_BLUR_FRAC = 0.02  # gaussian falloff sigma as a fraction of qsize
_FEATHER_GAIN = 3.0  # blur-feather steepness toward the padded border


def _quad_bounds(quad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Integer (lo_xy, hi_xy) bounding box of an oriented quad."""
    return (
        np.floor(quad.min(axis=0)).astype(int),
        np.ceil(quad.max(axis=0)).astype(int),
    )


def _shrink_stage(img, quad, qsize, output_size):
    """Downscale early when the face region dwarfs the output resolution."""
    import PIL.Image

    factor = int(qsize / output_size * 0.5)
    if factor <= 1:
        return img, quad, qsize
    new_wh = tuple(int(np.rint(s / factor)) for s in img.size)
    return img.resize(new_wh, PIL.Image.LANCZOS), quad / factor, qsize / factor


def _crop_stage(img, quad, border):
    """Crop to the quad's bbox + border, clipped to the image."""
    lo, hi = _quad_bounds(quad)
    lo = np.maximum(lo - border, 0)
    hi = np.minimum(hi + border, img.size)
    if np.any(hi - lo < img.size):
        img = img.crop((*lo, *hi))
        quad = quad - lo
    return img, quad


def _edge_ramp(n: int, lo_pad: int, hi_pad: int) -> np.ndarray:
    """1-D falloff: 1 at the outer padded edge, <=0 in the interior."""
    i = np.arange(n, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 1.0 - np.minimum(i / lo_pad, (n - 1 - i) / hi_pad)
    return np.nan_to_num(r, nan=1.0, posinf=1.0, neginf=1.0)


def _pad_stage(img, quad, qsize, border):
    """Reflect-pad where the quad leaves the image, feathering the padding
    into a blurred + median-filled extrapolation so the warp samples no hard
    reflection seams."""
    import PIL.Image
    import scipy.ndimage

    lo, hi = _quad_bounds(quad)
    need = np.array([border - lo[0], border - lo[1],
                     hi[0] - img.size[0] + border, hi[1] - img.size[1] + border])
    need = np.maximum(need, 0)  # (left, top, right, bottom)
    if need.max() <= border - 4:
        return img, quad
    pad = np.maximum(need, int(np.rint(qsize * _PAD_FRAC)))
    left, top, right, bottom = (int(p) for p in pad)

    arr = np.pad(np.float32(img), ((top, bottom), (left, right), (0, 0)), "reflect")
    h, w = arr.shape[:2]
    falloff = np.maximum(
        _edge_ramp(h, top, bottom)[:, None], _edge_ramp(w, left, right)[None, :]
    )[..., None]
    sigma = qsize * _BLUR_FRAC
    smoothed = scipy.ndimage.gaussian_filter(arr, [sigma, sigma, 0])
    arr += (smoothed - arr) * np.clip(falloff * _FEATHER_GAIN + 1.0, 0.0, 1.0)
    arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(falloff, 0.0, 1.0)

    img = PIL.Image.fromarray(np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
    return img, quad + pad[:2]


def align_face(
    img: Union[str, "PIL.Image.Image"],
    landmarks: Optional[np.ndarray] = None,
    landmark_fn: Optional[LandmarkFn] = None,
    output_size: int = 256,
    transform_size: int = 256,
    enable_padding: bool = True,
) -> "PIL.Image.Image":
    """FFHQ alignment: shrink -> border crop -> feathered reflect-pad ->
    QUAD warp, as the JAX package's `align_face`."""
    import PIL.Image

    if isinstance(img, str):
        img = PIL.Image.open(img)
    img = img.convert("RGB")
    if landmarks is None:
        if landmark_fn is None:
            raise ValueError("need landmarks or a landmark_fn")
        landmarks = landmark_fn(np.asarray(img))
    quad, qsize = align_quad(np.asarray(landmarks, np.float64))

    img, quad, qsize = _shrink_stage(img, quad, qsize, output_size)
    border = max(int(np.rint(qsize * _BORDER_FRAC)), 3)
    img, quad = _crop_stage(img, quad, border)
    if enable_padding:
        img, quad = _pad_stage(img, quad, qsize, border)

    img = img.transform(
        (transform_size, transform_size), PIL.Image.QUAD,
        (quad + 0.5).flatten(), PIL.Image.BILINEAR,
    )
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


def align_from_parsing(
    img: "PIL.Image.Image", parsing: np.ndarray, output_size: int = 256
) -> "PIL.Image.Image":
    """dlib-free alignment: derive anchor landmarks from a face-parsing map
    (in the segmentation model's frame), rescale them to the image frame, and
    run the FFHQ alignment. Backs `cli edit --align` without --landmarks.
    `parsing` is an (H, W) numpy array (a parsing tensor's `.cpu().numpy()`)."""
    scale = np.array(img.size, np.float64) / np.array(parsing.shape[::-1])
    lm = landmarks_from_parsing(parsing) * scale
    return align_face(
        img, landmarks=lm, output_size=output_size, transform_size=output_size
    )


def prepare_real_image_for_editing(
    image_path: str,
    landmark_fn: Optional[LandmarkFn] = None,
    landmarks: Optional[np.ndarray] = None,
    output_size: int = 256,
):
    """Align, then convert to a (1, 3, H, W) f32 tensor in [-1, 1]."""
    from .transforms import pil_to_tensor

    aligned = align_face(
        image_path, landmarks=landmarks, landmark_fn=landmark_fn,
        output_size=output_size, transform_size=output_size,
    )
    return pil_to_tensor(aligned)
