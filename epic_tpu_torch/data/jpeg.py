"""JPEG files through the repository's own decoder (``native/epic_jpeg.cpp``,
built with g++ at first use, bound with ctypes; no Pillow, no libjpeg).

``read_jpeg`` gives what Pillow's ``Image.open(path).convert("RGB")`` gives
on a Pillow built on libjpeg-turbo, bit for bit: baseline, extended and
progressive Huffman files, any sampling, restart markers, grey, YCbCr, RGB,
and Adobe CMYK / YCCK; Motion-JPEG files without Huffman tables (the
standard tables apply) and progressive files that stop before their
low-frequency coefficients are complete (block-smoothed as libjpeg-turbo
does). Arithmetic coding, lossless and hierarchical frames, 12-bit samples
and truncated data raise ValueError naming the file and the feature. The one call into C releases the GIL, so a thread pool decodes
in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native.build import load_jpeg_library

_MSG = 256


def _error(path: str, msg: ctypes.Array) -> ValueError:
    return ValueError(f"{path}: JPEG {msg.value.decode(errors='replace')}")


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB."""
    lib = load_jpeg_library()
    dims = (ctypes.c_int32 * 3)()
    msg = ctypes.create_string_buffer(_MSG)
    if lib.epic_jpeg_info(data, len(data), dims, msg, _MSG):
        raise _error(path, msg)
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    if lib.epic_jpeg_decode(data, len(data), out.ctypes.data, out.size, msg,
                            _MSG):
        raise _error(path, msg)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
