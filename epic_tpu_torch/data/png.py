"""PNG files with the standard library's ``zlib`` and numpy (no Pillow).

The reader takes every PNG colour type at every bit depth the format
allows (grey at 1, 2, 4, 8 and 16 bits; grey + alpha, RGB and RGBA at 8
and 16; palette at 1, 2, 4 and 8), interlaced (Adam7) or not, with any of
the five row filters, and converts them as Pillow's ``.convert("RGB")``
does: grey is repeated over the three channels (1, 2 and 4-bit grey scaled
by 255, 85 and 17), alpha (and ``tRNS``) is dropped, a palette index past
the ``PLTE`` entries is black, 16-bit colour keeps the high byte of each
sample and 16-bit grey is clipped to 255 (Pillow's ``I;16`` -> ``RGB``).
The writer writes RGB8 with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples of a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the format allows
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (a filter byte, then ``w * bpp`` bytes, per row)
    -> [h, w, bpp] uint8.

    A byte is predicted from the same byte of its left, upper and
    upper-left pixels, already decoded. So the pixels of one anti-diagonal
    (y + x = t) depend only on the two diagonals before it, and are decoded
    together, each row by its own filter: h + w - 1 vector steps instead of
    a Python loop over every byte. The image is held skewed, pixel (y, x)
    at [y + x + 2, y + 1], so that those diagonals are contiguous slices;
    the cells around the image stay zero, as the filters' borders are."""
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds = rows[:, :1]
    if kinds.max(initial=0) > 4:
        y = int(np.argmax(kinds[:, 0] > 4))
        raise ValueError(f"PNG row {y}: unknown filter type {kinds[y, 0]}")
    filtered = rows[:, 1:].reshape(h, w, bpp)
    if not kinds.any():
        return filtered.copy()
    yy, xx = np.mgrid[:h, :w]
    skew = (yy + xx + 2, yy + 1)
    f = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    f[skew] = filtered
    out = np.zeros_like(f)
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h, t + 1)
        a = out[t + 1, lo + 1:hi + 1]  # left
        b = out[t + 1, lo:hi]  # up
        c = out[t, lo:hi]  # up-left
        k = kinds[lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(k == 4, np.where((pa <= pb) & (pa <= pc), a,
                                         np.where(pb <= pc, b, c)),
                        np.where(k == 3, (a + b) >> 1,
                                 np.where(k == 2, b, np.where(k == 1, a, 0))))
        out[t + 2, lo + 1:hi + 1] = (f[t + 2, lo + 1:hi + 1] + pred) & 0xFF
    return out[skew].astype(np.uint8)


def _sub_byte(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """[h, stride] bytes of ``depth``-bit samples, the first in the top
    bits of its byte -> [h, w] values."""
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w]


def _palette_table(palette: bytes) -> np.ndarray:
    n = min(len(palette) // 3, 256)
    table = np.zeros((256, 3), np.uint8)
    table[:n] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
    return table


def _image_rgb(raw, h: int, w: int, depth: int, colour: int,
               palette) -> np.ndarray:
    """Filtered scanlines of one (sub-)image -> uint8 [h, w, 3]."""
    ch = CHANNELS[colour]
    if depth < 8:  # rows are filtered bytewise
        stride = (w * depth + 7) // 8
        idx = _sub_byte(_unfilter(raw, h, stride, 1)[..., 0], w, depth)
        if colour == 3:
            return _palette_table(palette)[idx]
        grey = idx * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    if depth == 8:
        px = _unfilter(raw, h, w, ch)
        if colour == 3:
            return _palette_table(palette)[px[..., 0]]
        if ch <= 2:  # grey (+ alpha)
            return np.repeat(px[..., :1], 3, axis=-1)
        return np.ascontiguousarray(px[..., :3])
    px = _unfilter(raw, h, w, 2 * ch)  # 16 bits, big-endian samples
    high = px[..., 0::2]
    if colour == 0:  # Pillow's I;16 -> RGB clips at 255
        v = (high.astype(np.uint16) << 8) | px[..., 1::2]
        grey = np.minimum(v[..., 0], 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=-1)
    if ch <= 2:
        return np.repeat(high[..., :1], 3, axis=-1)
    return np.ascontiguousarray(high[..., :3])


def _scanline_bytes(h: int, w: int, depth: int, colour: int) -> int:
    return h * ((w * depth * CHANNELS[colour] + 7) // 8 + 1)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 [H, W, 3] RGB as Pillow's ``convert("RGB")``
    gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette = None, [], None
    try:
        for kind, body in _chunks(data):
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"PLTE":
                palette = body
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth not in DEPTHS.get(colour, ()):
        raise ValueError(f"{path}: PNG of bit depth {depth} and colour type "
                         f"{colour} is not a valid PNG")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG of bit depth {depth} "
                         f"without PLTE")
    if interlace > 1:
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    raw = memoryview(zlib.decompress(b"".join(idat)))
    try:
        if not interlace:
            return _image_rgb(raw, h, w, depth, colour, palette)
        out = np.zeros((h, w, 3), np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:  # an empty pass has no scanlines
                continue
            out[y0::dy, x0::dx] = _image_rgb(raw[pos:], ph, pw, depth,
                                             colour, palette)
            pos += _scanline_bytes(ph, pw, depth, colour)
        return out
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def write_png(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] -> an RGB8 PNG file, filter 0 on every row."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """A PNG file -> float32 [H, W, 3] in [0, 1] (uint8 / 255), as the JAX
    package's ``data.datasets._load_image`` reads an image. Files of any
    format go through ``data/images.load_image``."""
    return read_png(path).astype(np.float32) / np.float32(255.0)


def to_uint8(x) -> np.ndarray:
    """A reconstruction in [0, 1] -> uint8 as the JAX package's CLIs save
    it: clipped to [0, 1], times 255, truncated."""
    return (np.clip(np.asarray(x, np.float32), 0, 1) * 255).astype(np.uint8)
