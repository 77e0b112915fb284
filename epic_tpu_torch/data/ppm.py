"""Netpbm files (P1-P6) with numpy (no Pillow), read as Pillow 12's
``PpmImagePlugin`` and ``.convert("RGB")`` give them.

P1 / P4 bitmaps (1 is black), P2 / P5 grey and P3 / P6 colour, plain or
raw, with a maxval up to 65535. Samples are scaled as Pillow scales them:
``round(v / maxval * 255)`` (Python's round, half to even) for colour and
for grey of maxval up to 255; grey of a larger maxval becomes Pillow's
32-bit "I" image, scaled to 65535 the same way (read as is at maxval
65535), which ``convert("RGB")`` clips at 255. The other magic numbers
Pillow knows (``Pf``, ``P0CMYK``, its test formats) raise ValueError.
"""

from __future__ import annotations

import numpy as np

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"


class _Reader:
    """Pillow's header tokenizer over the file's bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> bytes:
        b = self.data[self.pos:self.pos + 1]
        self.pos += len(b)
        return b

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.byte()
            if not c or c in _WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.byte()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.byte() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError("reached EOF while reading the PPM header")
        if len(token) > 10:
            raise ValueError("token too long in the PPM header")
        return token


def _strip_comments(body: bytes) -> bytes:
    """The plain formats' data with ``#`` comments (to CR or LF) removed."""
    out, pos = bytearray(), 0
    while True:
        start = body.find(b"#", pos)
        if start < 0:
            return bytes(out + body[pos:])
        out += body[pos:start]
        ends = [e for e in (body.find(b"\n", start), body.find(b"\r", start))
                if e >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    return np.minimum(out_max, np.round(v.astype(np.float64) / maxval
                                        * out_max)).astype(np.int64)


def read_ppm(path: str) -> np.ndarray:
    """A P1-P6 file -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    magic = r.magic()
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError(f"{path}: not a P1-P6 Netpbm file (magic {magic!r})")
    try:
        w, h = int(r.token()), int(r.token())
        maxval = 1
        if magic not in (b"P1", b"P4"):
            maxval = int(r.token())
            if not 0 < maxval < 65536:
                raise ValueError("maxval must be greater than 0 and less "
                                 "than 65536")
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    bands = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * bands
    body = data[r.pos:]
    if magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError(f"{path}: not enough PPM image data")
        bits = np.unpackbits(np.frombuffer(body, np.uint8, stride * h)
                             .reshape(h, stride), axis=1)[:, :w]
        grey = np.where(bits == 1, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=-1)
    if magic == b"P1":
        tokens = b"".join(_strip_comments(body).split())
        if any(t not in (48, 49) for t in tokens):
            raise ValueError(f"{path}: invalid token in a plain PBM file")
        if len(tokens) < w * h:
            raise ValueError(f"{path}: not enough PPM image data")
        bits = np.frombuffer(tokens, np.uint8, w * h).reshape(h, w)
        grey = np.where(bits == 49, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=-1)
    wide = maxval > 255 and bands == 1  # Pillow's mode "I"
    out_max = 65535 if wide else 255
    if magic in (b"P2", b"P3"):
        tokens = _strip_comments(body).split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise ValueError(f"{path}: token too long in PPM data")
        v = np.array([int(t) for t in tokens], np.int64)
        if (v < 0).any() or (v > maxval).any():
            raise ValueError(f"{path}: PPM sample out of range 0..{maxval}")
        if len(v) < n:
            raise ValueError(f"{path}: not enough PPM image data")
        v = _scale(v, maxval, out_max)
    else:
        size = 2 if maxval > 255 else 1
        if len(body) < n * size:
            raise ValueError(f"{path}: not enough PPM image data")
        v = np.frombuffer(body, ">u2" if size == 2 else np.uint8, n)
        if not (maxval == 255 or (maxval == 65535 and wide)):
            v = _scale(v, maxval, out_max)
    v = np.minimum(v, 255).astype(np.uint8).reshape(h, w, bands)
    return v if bands == 3 else np.repeat(v, 3, axis=-1)
