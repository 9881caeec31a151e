"""Native (C++) host ops through ctypes: the port of `ops/native/`.

`host_ops.cpp` builds with g++ at first use into `ops/.build/` (ignored by
git; the library's name carries a digest of the source and the flags, so an
edited source never loads a stale build). Every entry point keeps its numpy
version beside it, taken when the toolchain is absent:

* `merge_part_masks_native(parts)`: CelebAMask-HQ's part masks -> one label
  map;
* `resize_bilinear_u8`, `normalize_imagenet`, `to_symmetric_range`: the
  data loader's fast paths.

The JAX package's XLA FFI custom calls (`label_merge_ffi`,
`imagenet_normalize_ffi`) run these inside jitted input pipelines; torch
has no traced input pipeline to call them from, so they are not ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / ".build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS: dict = {}


def library_path(name: str = "host_ops") -> Path:
    src = _DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> Optional[Path]:
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_DIR / f"{name}.cpp"), "-o", str(tmp)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def host_lib() -> Optional[ctypes.CDLL]:
    """The built library, or None without a toolchain."""
    with _LOCK:
        if "host_ops" not in _LIBS:
            so = _build("host_ops")
            _LIBS["host_ops"] = ctypes.CDLL(str(so)) if so else None
        return _LIBS["host_ops"]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def merge_part_masks_numpy(parts: np.ndarray, marker: int = 225) -> np.ndarray:
    p, h, w = parts.shape
    out = np.zeros((h, w), np.uint8)
    for i in range(p):
        out[parts[i] == marker] = i + 1
    return out


def merge_part_masks_native(parts: np.ndarray, marker: int = 225) -> np.ndarray:
    """(P, H, W) uint8 part masks -> (H, W) uint8 label map: part i -> i + 1
    where its pixel is `marker`, later parts win."""
    parts = np.ascontiguousarray(parts, np.uint8)
    lib = host_lib()
    if lib is None:
        return merge_part_masks_numpy(parts, marker)
    p, h, w = parts.shape
    out = np.zeros(h * w, np.uint8)
    lib.die_merge_part_masks(_u8(parts), ctypes.c_int(p), ctypes.c_int(h * w),
                             ctypes.c_uint8(marker), _u8(out))
    return out.reshape(h, w)


def resize_bilinear_u8_numpy(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    ih, iw, _ = img.shape
    ys = np.clip((np.arange(oh) + 0.5) * ih / oh - 0.5, 0, ih - 1)
    xs = np.clip((np.arange(ow) + 0.5) * iw / ow - 0.5, 0, iw - 1)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, ih - 1), np.minimum(x0 + 1, iw - 1)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    f = img.astype(np.float32)
    v = (f[np.ix_(y0, x0)] * (1 - wy) * (1 - wx) + f[np.ix_(y0, x1)] * (1 - wy) * wx
         + f[np.ix_(y1, x0)] * wy * (1 - wx) + f[np.ix_(y1, x1)] * wy * wx)
    return np.clip(v + 0.5, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(H, W, C) uint8 -> (oh, ow, C) uint8, half-pixel bilinear."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = host_lib()
    if lib is None:
        return resize_bilinear_u8_numpy(img, oh, ow)
    ih, iw, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    lib.die_resize_bilinear_u8(_u8(img), ctypes.c_int(ih), ctypes.c_int(iw), ctypes.c_int(c),
                               _u8(out), ctypes.c_int(oh), ctypes.c_int(ow))
    return out


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet_numpy(img: np.ndarray) -> np.ndarray:
    return ((img / 255.0).astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> float32, ImageNet-normalised."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = host_lib()
    if lib is None:
        return normalize_imagenet_numpy(img)
    out = np.empty(img.shape, np.float32)
    lib.die_normalize_imagenet(_u8(img), ctypes.c_int(img.shape[0] * img.shape[1]), _f32(out))
    return out


def to_symmetric_range_numpy(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) * (2.0 / 255.0) - 1.0


def to_symmetric_range(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = host_lib()
    if lib is None:
        return to_symmetric_range_numpy(img)
    out = np.empty(img.shape, np.float32)
    lib.die_to_symmetric_range(_u8(img), ctypes.c_int64(img.size), _f32(out))
    return out
