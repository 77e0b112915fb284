"""zstd frames through the repository's own decoder (``native/epic_zstd.cpp``,
built with g++ at first use, bound with ctypes; no zstd package).

``decompress`` gives what ``zstandard.ZstdDecompressor().decompressobj(
read_across_frames=True).decompress(data)`` gives: concatenated frames one
after another, skippable frames stepped over, each frame's XXH64 content
checksum checked when it has one. Dictionary frames and corrupt or truncated
input raise ValueError. The call into C releases the GIL, so a thread pool
decodes in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_zstd_library

_MSG = 256


def _error(msg: ctypes.Array) -> ValueError:
    return ValueError(f"zstd: {msg.value.decode(errors='replace')}")


def decompress(data: bytes) -> bytes:
    """Every zstd frame of ``data``, decoded and joined."""
    lib = load_zstd_library()
    msg = ctypes.create_string_buffer(_MSG)
    ptr = ctypes.c_void_p()
    n = ctypes.c_int64()
    if lib.epic_zstd_decode(data, len(data), ctypes.byref(ptr),
                            ctypes.byref(n), msg, _MSG):
        raise _error(msg)
    try:
        return ctypes.string_at(ptr, n.value) if n.value else b""
    finally:
        lib.epic_zstd_free(ptr)


def decompress_into(data: bytes, out: np.ndarray) -> None:
    """Decodes ``data`` into the C-contiguous array ``out``, whose byte size
    must be the decoded size exactly."""
    if not out.flags.c_contiguous:
        raise ValueError("zstd: output array must be C-contiguous")
    lib = load_zstd_library()
    msg = ctypes.create_string_buffer(_MSG)
    n = ctypes.c_int64()
    if lib.epic_zstd_decode_into(data, len(data), out.ctypes.data, out.nbytes,
                                 ctypes.byref(n), msg, _MSG):
        raise _error(msg)
    if n.value != out.nbytes:
        raise ValueError(f"zstd: decoded {n.value} bytes, expected "
                         f"{out.nbytes}")

