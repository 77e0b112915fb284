"""Build and load the host libraries: the rANS coder (``epic_rans.cpp``),
the JPEG decoder (``epic_jpeg.cpp``) and the zstd decoder
(``epic_zstd.cpp``).

Each source is compiled with g++ on first use into ``native/_build/``
(listed in ``.gitignore``), under a name keyed by a hash of the source text
so an edit triggers a rebuild. The libraries have plain C interfaces, bound
with ctypes (``ctypes.CDLL``, which releases the GIL for each call). The
JPEG and zstd decoders are built without ``-march=native``: their integer
arithmetic gives the same bytes on any x86-64 host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "epic_rans.cpp")
_JPEG_SRC = os.path.join(_HERE, "epic_jpeg.cpp")
_ZSTD_SRC = os.path.join(_HERE, "epic_zstd.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_JPEG_LIB: ctypes.CDLL | None = None
_ZSTD_LIB: ctypes.CDLL | None = None


def _library_path(src: str, stem: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")


def _compile(src: str, path: str, flags) -> str:
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *flags, src,
               "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def library_path() -> str:
    return _library_path(_SRC, "epic_rans")


def build_library() -> str:
    """Compile the rANS library if it is not built yet; returns its path."""
    return _compile(_SRC, library_path(), ["-march=native", "-pthread"])


def jpeg_library_path() -> str:
    return _library_path(_JPEG_SRC, "epic_jpeg")


def build_jpeg_library() -> str:
    """Compile the JPEG decoder if it is not built yet; returns its path."""
    return _compile(_JPEG_SRC, jpeg_library_path(), [])


def zstd_library_path() -> str:
    return _library_path(_ZSTD_SRC, "epic_zstd")


def build_zstd_library() -> str:
    """Compile the zstd decoder if it is not built yet; returns its path."""
    return _compile(_ZSTD_SRC, zstd_library_path(), [])


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i32p, u32p, i64p, u8p, f32p = (
        c.POINTER(c.c_int32), c.POINTER(c.c_uint32), c.POINTER(c.c_int64),
        c.POINTER(c.c_uint8), c.POINTER(c.c_float),
    )
    i8p, i16p = c.POINTER(c.c_int8), c.POINTER(c.c_int16)
    sigs = {
        "epic_pmf_to_quantized_cdf": (
            c.c_int32, [f32p, c.c_int32, c.c_int32, u32p]),
        "epic_pmf_to_quantized_cdf_batch": (
            c.c_int32, [f32p, c.c_int64, i32p, c.c_int32, c.c_int32, u32p,
                        c.c_int64, c.c_int32]),
        "epic_rans_encode": (
            c.c_int64, [i32p, i32p, c.c_int64, u32p, c.c_int64, i32p, i32p,
                        c.c_int32, u8p, c.c_int64]),
        "epic_rans_decode": (
            c.c_int32, [u8p, c.c_int64, i32p, c.c_int64, u32p, c.c_int64,
                        i32p, i32p, c.c_int32, i32p]),
        "epic_rans_encode_seg_batch": (
            c.c_int32, [i32p, i32p, i64p, i64p, c.c_int32, i64p, c.c_int32,
                        u32p, c.c_int64, i32p, i32p, c.c_int32, u8p,
                        c.c_int64, i64p, i64p, c.c_int32]),
        "epic_rans_encode_batch": (
            c.c_int32, [i32p, i32p, i64p, i64p, c.c_int32, u32p, c.c_int64,
                        i32p, i32p, c.c_int32, u8p, c.c_int64, i64p,
                        c.c_int32]),
        "epic_rans_decode_batch": (
            c.c_int32, [u8p, i64p, i64p, i32p, i64p, i64p, c.c_int32, u32p,
                        c.c_int64, i32p, i32p, c.c_int32, i32p, c.c_int32]),
        "epic_rans_stream_decode_batch": (
            c.c_int32, [c.POINTER(c.c_void_p), c.c_int32, i32p, i64p, i64p,
                        u32p, c.c_int64, i32p, i32p, c.c_int32, i32p,
                        c.c_int32]),
        "epic_rans_encode_shell_batch": (
            c.c_int32, [c.c_void_p, c.c_int32, u8p, c.c_int64,
                        c.c_void_p, c.c_int32, u8p, i8p, c.c_int64,
                        c.c_int32, c.c_int32,
                        u32p, c.c_int64, i32p, i32p, c.c_int32,
                        u8p, c.c_int64, i64p, i64p, c.c_int32]),
        "epic_rans_stream_decode_shell_batch": (
            c.c_int32, [c.POINTER(c.c_void_p), c.c_int32,
                        u8p, i8p, c.c_int64,
                        c.c_int32, c.c_int32, c.c_int32,
                        u32p, c.c_int64, i32p, i32p, c.c_int32,
                        i16p,
                        i64p, i32p, c.c_int32, c.c_int32]),
        "epic_rans_stream_new": (c.c_void_p, [u8p, c.c_int64]),
        "epic_rans_stream_decode": (
            c.c_int32, [c.c_void_p, i32p, c.c_int64, u32p, c.c_int64, i32p,
                        i32p, c.c_int32, i32p]),
        "epic_rans_stream_free": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_jpeg_library() -> ctypes.CDLL:
    global _JPEG_LIB
    if _JPEG_LIB is None:
        with _LOCK:
            if _JPEG_LIB is None:
                lib = ctypes.CDLL(build_jpeg_library())
                c = ctypes
                lib.epic_jpeg_info.restype = c.c_int32
                lib.epic_jpeg_info.argtypes = [
                    c.c_char_p, c.c_int64, c.POINTER(c.c_int32), c.c_char_p,
                    c.c_int32]
                lib.epic_jpeg_decode.restype = c.c_int32
                lib.epic_jpeg_decode.argtypes = [
                    c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, c.c_char_p,
                    c.c_int32]
                _JPEG_LIB = lib
    return _JPEG_LIB


def load_zstd_library() -> ctypes.CDLL:
    global _ZSTD_LIB
    if _ZSTD_LIB is None:
        with _LOCK:
            if _ZSTD_LIB is None:
                lib = ctypes.CDLL(build_zstd_library())
                c = ctypes
                i64p = c.POINTER(c.c_int64)
                lib.epic_zstd_decode_into.restype = c.c_int32
                lib.epic_zstd_decode_into.argtypes = [
                    c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, i64p,
                    c.c_char_p, c.c_int32]
                lib.epic_zstd_decode.restype = c.c_int32
                lib.epic_zstd_decode.argtypes = [
                    c.c_char_p, c.c_int64, c.POINTER(c.c_void_p), i64p,
                    c.c_char_p, c.c_int32]
                lib.epic_zstd_free.restype = None
                lib.epic_zstd_free.argtypes = [c.c_void_p]
                _ZSTD_LIB = lib
    return _ZSTD_LIB


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build_library())
                _declare(lib)
                _LIB = lib
    return _LIB
