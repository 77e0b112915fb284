"""Image files of every format the JAX package reads (its loader lists
``.png .jpg .jpeg .bmp .ppm`` and opens them with Pillow).

The reader is chosen by the file's first bytes, as Pillow chooses it, not
by the file's name: JPEG (``data/jpeg.py``), PNG (``data/png.py``), BMP
(``data/bmp.py``) and Netpbm P1-P6 (``data/ppm.py``). Each gives what
Pillow's ``Image.open(path).convert("RGB")`` gives; any other content
raises ValueError naming the file.
"""

from __future__ import annotations

import numpy as np

from .bmp import read_bmp
from .jpeg import read_jpeg
from .png import SIGNATURE as _PNG, read_png
from .ppm import read_ppm


def image_format(head: bytes) -> str | None:
    """The format whose magic bytes start ``head``, as Pillow's plugins
    accept them, or None."""
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(_PNG):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if len(head) >= 2 and head[:1] == b"P" and head[1:2] in b"0123456fy":
        return "ppm"  # read_ppm names the variants it refuses
    return None


_READERS = {"jpeg": read_jpeg, "png": read_png, "bmp": read_bmp,
            "ppm": read_ppm}


def read_image(path: str) -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        head = f.read(8)
    kind = image_format(head)
    if kind is None:
        raise ValueError(f"{path}: not a JPEG, PNG, BMP or P1-P6 Netpbm "
                         f"file (starts {head[:4]!r})")
    return _READERS[kind](path)


def load_image(path: str) -> np.ndarray:
    """An image file -> float32 [H, W, 3] in [0, 1] (uint8 / 255), as the
    JAX package's ``data.datasets._load_image`` reads it."""
    return read_image(path).astype(np.float32) / np.float32(255.0)
