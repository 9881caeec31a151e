"""CelebAMask-HQ data pipeline (host-side, PIL/numpy) for BiSeNet training:
the port's own copy of the JAX package's `seg/data.py`.

Label-merge preprocessing, label-aware augmentations (ColorJitter,
HorizontalFlip with left/right class-id swaps, RandomScale, RandomCrop), a
background prefetch thread and a batch iterator that yields NHWC numpy
batches (the trainer moves them to the device and to NCHW); the
`DistributedSampler` equivalent is slicing by process index. PIL is
imported inside the functions that use it, so the module imports where PIL
is absent (the synthetic feed needs none).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CELEBA_PART_NAMES = [
    "skin", "l_brow", "r_brow", "l_eye", "r_eye", "eye_g", "l_ear", "r_ear",
    "ear_r", "nose", "mouth", "u_lip", "l_lip", "neck", "neck_l", "cloth",
    "hair", "hat",
]

# left/right-paired class ids swapped on horizontal flip (transform.py:49-55)
_FLIP_SWAPS = [(2, 3), (4, 5), (7, 8)]


def merge_part_masks(part_masks: dict, size: int = 512) -> np.ndarray:
    """Merge per-part CelebAMask-HQ annotation masks into one 19-class label
    map (`prepropess_data.py:15-38`): part pixels == 225 get class id
    (index in CELEBA_PART_NAMES) + 1; background stays 0."""
    label = np.zeros((size, size), np.uint8)
    for l, att in enumerate(CELEBA_PART_NAMES, start=1):
        m = part_masks.get(att)
        if m is not None:
            label[np.asarray(m) == 225] = l
    return label


def preprocess_celebamask(anno_dir: str, out_dir: str, num_images: int = 30000) -> None:
    """Batch label-merge over the CelebAMask-HQ-mask-anno layout
    (15 folders x 2000 images)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for j in range(num_images):
        folder = str(j // 2000)
        parts = {}
        for att in CELEBA_PART_NAMES:
            path = osp.join(anno_dir, folder, f"{str(j).rjust(5, '0')}_{att}.png")
            if os.path.exists(path):
                parts[att] = np.array(Image.open(path).convert("P"))
        Image.fromarray(merge_part_masks(parts)).save(osp.join(out_dir, f"{j}.png"))


# ---------------------------------------------------------------------------
# Augmentations (im: PIL RGB, lb: PIL P-mode label map)
# ---------------------------------------------------------------------------


def color_jitter(im, rng, brightness=0.5, contrast=0.5, saturation=0.5):
    from PIL import ImageEnhance

    b = rng.uniform(max(1 - brightness, 0), 1 + brightness)
    c = rng.uniform(max(1 - contrast, 0), 1 + contrast)
    s = rng.uniform(max(1 - saturation, 0), 1 + saturation)
    im = ImageEnhance.Brightness(im).enhance(b)
    im = ImageEnhance.Contrast(im).enhance(c)
    im = ImageEnhance.Color(im).enhance(s)
    return im


def horizontal_flip(im, lb, rng, p=0.5):
    from PIL import Image

    if rng.random() > p:
        return im, lb
    arr = np.array(lb)
    flipped = arr.copy()
    for a, b in _FLIP_SWAPS:
        flipped[arr == a] = b
        flipped[arr == b] = a
    lb = Image.fromarray(flipped)
    return (
        im.transpose(Image.FLIP_LEFT_RIGHT),
        lb.transpose(Image.FLIP_LEFT_RIGHT),
    )


def random_scale(im, lb, rng, scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0)):
    from PIL import Image

    scale = scales[rng.integers(len(scales))]
    w, h = im.size
    size = (int(w * scale), int(h * scale))
    return im.resize(size, Image.BILINEAR), lb.resize(size, Image.NEAREST)


def random_crop(im, lb, rng, size: Tuple[int, int]):
    from PIL import Image

    cw, ch = size
    w, h = im.size
    if (cw, ch) == (w, h):
        return im, lb
    if w < cw or h < ch:
        scale = float(cw) / w if w < h else float(ch) / h
        w, h = int(scale * w + 1), int(scale * h + 1)
        im = im.resize((w, h), Image.BILINEAR)
        lb = lb.resize((w, h), Image.NEAREST)
    sw = int(rng.random() * (w - cw))
    sh = int(rng.random() * (h - ch))
    box = (sw, sh, sw + cw, sh + ch)
    return im.crop(box), lb.crop(box)


def multi_scale(im, scales: Sequence[float]) -> list:
    """Multi-scale evaluation pyramid (`transform.py:96-119`): bilinear
    resizes of `im` at each ratio, for scale-averaged inference."""
    from PIL import Image

    w, h = im.size
    return [im.resize((int(w * r), int(h * r)), Image.BILINEAR) for r in scales]


def train_transform(im, lb, rng, crop_size=(448, 448)):
    """The training Compose of `face_dataset.py:35-42`."""
    im = color_jitter(im, rng)
    im, lb = horizontal_flip(im, lb, rng)
    im, lb = random_scale(im, lb, rng)
    im, lb = random_crop(im, lb, rng, crop_size)
    return im, lb


def to_model_input(im) -> np.ndarray:
    """PIL -> ImageNet-normalized float32 HWC (`face_dataset.py:30-33`)."""
    a = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return (a - IMAGENET_MEAN) / IMAGENET_STD


class FaceMaskDataset:
    """CelebAMask-HQ images + merged label maps (`face_dataset.py:19-59`).

    raw=True emits (uint8 RGB, uint8 labels) and defers the ImageNet
    normalization to the DEVICE (`train._prep_batch`): the host->HBM
    transfer then carries 4x fewer bytes — identical arithmetic (labels are
    0..18 + ignore 255, exactly uint8's range)."""

    def __init__(self, root: str, crop_size=(448, 448), mode: str = "train",
                 raw: bool = False):
        assert mode in ("train", "val", "test")
        self.root = root
        self.mode = mode
        self.crop_size = crop_size
        self.ignore_lb = 255
        self.raw = raw
        self.imgs: List[str] = sorted(os.listdir(osp.join(root, "CelebA-HQ-img")))

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image

        rng = rng or np.random.default_rng()
        name = self.imgs[idx]
        im = Image.open(osp.join(self.root, "CelebA-HQ-img", name)).resize(
            (512, 512), Image.BILINEAR
        )
        lb = Image.open(osp.join(self.root, "mask", name[:-3] + "png")).convert("P")
        if self.mode == "train":
            im, lb = train_transform(im, lb, rng, self.crop_size)
        if self.raw:
            return (np.asarray(im.convert("RGB"), np.uint8),
                    np.array(lb).astype(np.uint8))
        return to_model_input(im), np.array(lb).astype(np.int32)


class _PrefetchDone:
    pass


class _PrefetchError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Bounded background-thread prefetch: the producer thread pulls from the
    wrapped iterator and fills a queue while the consumer (the training loop)
    blocks on the device step, overlapping host augmentation with device
    compute, the role of the reference's 8-worker DataLoader
    (`src/Segmentation/train.py:63-70`). `size` is the number of batches kept
    in flight (2 = classic double buffering)."""

    def __init__(self, it: Iterator, size: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(it,), name="die-prefetch", daemon=True
        )
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        import queue

        try:
            for item in it:
                # bounded put that stays responsive to close()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_PrefetchDone())
        except BaseException as e:  # surfaced on the consumer side
            self._q.put(_PrefetchError(e))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _PrefetchDone):
            raise StopIteration
        if isinstance(item, _PrefetchError):
            raise item.exc
        return item

    def close(self) -> None:
        self._stop.set()

    def __del__(self):  # belt-and-braces; the thread is daemon anyway
        self._stop.set()


def batch_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    prefetch: int = 0,
    num_workers: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled (images, labels) NHWC batches; per-process sharding
    by slicing (the `DistributedSampler` of `train.py:63`). The process
    index and count come from the arguments, else from torch.distributed
    when it is initialised, else 0 and 1.

    prefetch>0 wraps the stream in a PrefetchIterator holding that many
    batches in flight (host augmentation overlaps device steps).
    num_workers>0 additionally loads the items of each batch through a thread
    pool; per-item RNGs are then derived from (seed, epoch, index) so the
    augmentation stream is deterministic regardless of thread scheduling
    (num_workers=0 keeps the original shared-rng sequential stream)."""
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if distributed else 0
    if process_count is None:
        process_count = dist.get_world_size() if distributed else 1
    pi, pc = process_index, process_count
    rng = np.random.default_rng(seed + pi)
    n = len(dataset)
    indices = np.arange(n)[pi::pc]

    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers,
                                  thread_name_prefix="die-loader")

    def produce() -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = 0
        while True:
            order = rng.permutation(indices) if shuffle else indices
            for i in range(0, len(order) - batch_size + 1, batch_size):
                chunk = order[i : i + batch_size]
                if num_workers > 0:
                    items = list(pool.map(
                        lambda j: dataset.__getitem__(
                            int(j),
                            np.random.default_rng((seed + pi, epoch, int(j))),
                        ),
                        chunk,
                    ))
                else:
                    items = [dataset.__getitem__(j, rng) for j in chunk]
                images = np.stack([x[0] for x in items])
                labels = np.stack([x[1] for x in items])
                yield images, labels
            epoch += 1

    if prefetch > 0:
        return PrefetchIterator(produce(), size=prefetch)
    return produce()


class SyntheticFaceMask:
    """Random-data stand-in with the FaceMaskDataset interface (for tests and
    benchmarking without the CelebAMask-HQ download)."""

    def __init__(self, n: int = 64, size: int = 64, n_classes: int = 19,
                 raw: bool = False):
        self.n, self.size, self.n_classes, self.raw = n, size, n_classes, raw

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        rng = rng or np.random.default_rng(idx)
        if self.raw:  # uint8 feed (normalised on the device, train._prep_batch)
            img = rng.integers(0, 256, (self.size, self.size, 3)).astype(np.uint8)
            lab = rng.integers(0, self.n_classes,
                               (self.size, self.size)).astype(np.uint8)
            return img, lab
        img = rng.normal(size=(self.size, self.size, 3)).astype(np.float32)
        lab = rng.integers(0, self.n_classes, (self.size, self.size)).astype(np.int32)
        return img, lab
