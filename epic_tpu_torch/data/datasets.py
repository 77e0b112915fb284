"""Image-folder datasets and a thread-pool host loader of NHWC float32
batches, as the JAX package's ``data/datasets.py``: the same split
resolution (``root/split/data``, then ``root/split``, then ``root``), the
same listing of image files, and the same ``random.Random`` draws (the
order shuffle, one crop seed per image drawn before the images are
dispatched to the pool, the reflect pad of images smaller than the patch),
so that the same files and seed give the same batches bit for bit.

Images are read by ``data/images.py`` (no Pillow): JPEG, PNG, BMP and
Netpbm files, each chosen by its first bytes and decoded as Pillow's
``convert("RGB")`` gives it.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from .images import load_image

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def _list_images(root: str) -> List[str]:
    out = [os.path.join(root, f) for f in sorted(os.listdir(root))
           if f.lower().endswith(_EXTS)]
    if not out:
        raise FileNotFoundError(f"no images under {root}")
    return out


def _load_image(path: str) -> np.ndarray:
    """float32 [H, W, 3] in [0, 1] (uint8 / 255)."""
    return load_image(path)


def _random_crop(img: np.ndarray, size: int, rng: random.Random):
    h, w = img.shape[:2]
    if h < size or w < size:  # pad small images by reflection
        ph, pw = max(size - h, 0), max(size - w, 0)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = rng.randint(0, h - size)
    left = rng.randint(0, w - size)
    return img[top:top + size, left:left + size]


class ImageFolder:
    """``root/{split}/data`` (or ``root/{split}``, or ``root``) with random
    ``patch_size`` crops, at most ``num_images`` files."""

    def __init__(self, root: str, split: str = "train",
                 patch_size: int = 256, num_images: Optional[int] = None):
        base = os.path.join(root, split, "data")
        if not os.path.isdir(base):
            base = os.path.join(root, split)
        if not os.path.isdir(base):
            base = root
        self.paths = _list_images(base)
        if num_images:
            self.paths = self.paths[:num_images]
        self.patch_size = patch_size

    def __len__(self):
        return len(self.paths)

    def get(self, index: int, rng: random.Random) -> np.ndarray:
        img = _load_image(self.paths[index % len(self.paths)])
        return _random_crop(img, self.patch_size, rng)


class TestImageDataset:
    """A flat directory of test images, in file-name order: yields (image,
    path)."""

    def __init__(self, data_dir: str, num_images: Optional[int] = None):
        self.paths = _list_images(data_dir)
        if num_images:
            self.paths = self.paths[:num_images]

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for p in self.paths:
            yield _load_image(p), p


def data_loader(dataset: ImageFolder, batch_size: int, seed: int = 0,
                steps: Optional[int] = None, num_workers: int = 8
                ) -> Iterator[np.ndarray]:
    """Yields [B, P, P, 3] float32 batches (``steps`` of them, or without
    end), the images loaded on ``num_workers`` threads."""
    rng = random.Random(seed)
    order = list(range(len(dataset)))
    rng.shuffle(order)
    pos = 0
    produced = 0
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        while steps is None or produced < steps:
            idxs = []
            for _ in range(batch_size):
                if pos >= len(order):
                    rng.shuffle(order)
                    pos = 0
                idxs.append(order[pos])
                pos += 1
            # the crop seeds are drawn before the pool runs, so that a
            # batch does not depend on the threads' schedule
            seeds = [rng.random() for _ in idxs]
            crops = list(pool.map(
                lambda a: dataset.get(a[0], random.Random(a[1])),
                zip(idxs, seeds)))
            yield np.stack(crops)
            produced += 1
