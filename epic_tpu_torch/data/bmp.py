"""BMP files with numpy (no Pillow), read as Pillow 12's ``BmpImagePlugin``
and ``.convert("RGB")`` give them.

Read: the OS/2 core header (12 bytes) and the Windows headers of 40, 52,
56, 64, 108 and 124 bytes; ``BI_RGB`` at 1, 4 and 8 bits (a palette), 16
(5-5-5), 24 and 32 bits, bottom-up or top-down; ``BI_BITFIELDS`` with the
masks Pillow knows (16 bits 5-6-5 and 5-5-5, 24 bits, 32 bits with the
byte masks of its table); ``BI_RLE8`` and ``BI_RLE4`` through a copy of
Pillow's Python RLE decoder, its quirks included (a delta reads four bytes
after the escape, an absolute run of odd length in RLE4 drops its last
pixel). A palette whose entries are the grey ramp is read as grey, as
Pillow does; alpha is dropped. Anything else raises ValueError naming the
file and the feature.
"""

from __future__ import annotations

import struct

import numpy as np

# (bits, (r, g, b, a) masks) of BI_BITFIELDS files Pillow reads
_MASKS32 = (
    (0xFF0000, 0xFF00, 0xFF, 0x0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
    (0x0, 0x0, 0x0, 0x0),
)
_RGB565 = (0xF800, 0x7E0, 0x1F)
_RGB555 = (0x7C00, 0x3E0, 0x1F)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _bits16(px: np.ndarray, five_six_five: bool) -> np.ndarray:
    """uint16 pixels -> [.., 3] as Pillow's BGR;16 / BGR;15 unpackers
    scale them (``v * 255 // max``)."""
    px = px.astype(np.uint32)
    b = (px & 31) * 255 // 31
    if five_six_five:
        g = ((px >> 5) & 63) * 255 // 63
        r = ((px >> 11) & 31) * 255 // 31
    else:
        g = ((px >> 5) & 31) * 255 // 31
        r = ((px >> 10) & 31) * 255 // 31
    return np.stack([r, g, b], -1).astype(np.uint8)


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """Pillow's ``BmpRleDecoder.decode``: rows of indices, in file order."""
    out = bytearray()
    x = 0
    dest = w * h

    def read(k: int) -> bytes:
        nonlocal pos
        b = data[pos:pos + k]
        pos += len(b)
        return b

    while len(out) < dest:
        pair = read(2)
        if len(pair) < 2:
            break
        count, byte = pair[0], pair[1]
        if count:  # encoded mode
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                hi, lo = byte >> 4, byte & 0x0F
                out += bytes(hi if i % 2 == 0 else lo for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            while len(out) % w != 0:
                out.append(0)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow reads two bytes, then two more
            if len(read(2)) < 2:
                break
            right_up = read(2)
            right, up = right_up[0], right_up[1]
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute mode
            if rle4:
                got = read(byte // 2)
                for v in got:
                    out += bytes([v >> 4, v & 0x0F])
                short = len(got) < byte // 2
            else:
                got = read(byte)
                out += got
                short = len(got) < byte
            if short:
                break
            x += byte
            if pos % 2 != 0:  # align to 16 bits in the file
                pos += 1
    return bytes(out)


def read_bmp(path: str) -> np.ndarray:
    """A BMP file -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        data = f.read()

    def refuse(what: str):
        raise ValueError(f"{path}: {what}")

    if len(data) < 18 or not data.startswith(b"BM"):
        refuse("not a BMP file")
    offset = _u32(data, 10)
    hsize = _u32(data, 14)
    hdr = data[18:14 + hsize]
    if len(hdr) < hsize - 4:
        refuse("truncated BMP header")
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        w, h = _u16(hdr, 0), _u16(hdr, 2)
        bits = _u16(hdr, 6)
        comp, colors, pal_pad, direction = _RAW, 0, 3, -1
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = hdr[7] == 0xFF
        direction = 1 if y_flip else -1
        w = _u32(hdr, 0)
        h = _u32(hdr, 4) if not y_flip else 2 ** 32 - _u32(hdr, 4)
        bits = _u16(hdr, 10)
        comp = _u32(hdr, 12)
        colors = _u32(hdr, 28)
        pal_pad = 4
        if comp == _BITFIELDS:
            if len(hdr) >= 48:
                masks = [_u32(hdr, 36 + 4 * i) for i in range(3)]
                masks.append(_u32(hdr, 48) if len(hdr) >= 52 else 0)
            else:  # 40-byte header: three masks follow it
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        refuse(f"unsupported BMP header size {hsize}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        refuse(f"unsupported BMP bit depth {bits}")
    if w == 0 or h == 0:
        refuse("empty BMP image")

    layout = None  # how the raw rows are unpacked
    if comp == _BITFIELDS:
        if bits == 32 and tuple(masks) in _MASKS32:
            layout = ("masks32", tuple(masks))
        elif bits == 24 and tuple(masks[:3]) == (0xFF0000, 0xFF00, 0xFF):
            layout = ("bgr24", None)
        elif bits == 16 and tuple(masks[:3]) in (_RGB565, _RGB555):
            layout = ("bits16", tuple(masks[:3]) == _RGB565)
        else:
            refuse(f"BMP bitfields {bits}-bit layout "
                   f"{tuple(hex(m) for m in masks)}")
    elif comp == _RAW:
        layout = {16: ("bits16", False), 24: ("bgr24", None),
                  32: ("masks32", (0xFF0000, 0xFF00, 0xFF, 0x0))}.get(
                      bits, ("indices", None))
    elif comp in (_RLE8, _RLE4):
        if bits != (8 if comp == _RLE8 else 4):
            refuse(f"BMP RLE{8 if comp == _RLE8 else 4} compression at "
                   f"{bits} bits")
        layout = ("rle", comp == _RLE4)
    else:
        refuse(f"unsupported BMP compression {comp}")

    table, grey = None, False
    if bits <= 8:
        if not 0 < colors <= 65536:
            refuse(f"unsupported BMP palette size {colors}")
        pal = data[pos:pos + pal_pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * pal_pad:i * pal_pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        n = len(pal) // pal_pad
        entries = np.frombuffer(pal, np.uint8, n * pal_pad).reshape(
            n, pal_pad)[:256, 2::-1]
        table = np.zeros((256, 3), np.uint8)
        table[:len(entries)] = entries

    if layout[0] == "rle":
        idx = _rle(data, offset, w, h, layout[1])
        if len(idx) < w * h:
            refuse("not enough BMP image data")
        img = np.frombuffer(idx, np.uint8, w * h).reshape(h, w)
        if direction == -1:
            img = img[::-1]
        if grey:  # Pillow's "L": the index is the grey value
            return np.repeat(img[..., None], 3, axis=-1)
        return table[img]

    stride = ((w * bits + 31) >> 3) & ~3
    if offset + stride * (h - 1) + (w * bits + 7) // 8 > len(data):
        refuse("not enough BMP image data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset) \
        if offset + stride * h <= len(data) else np.frombuffer(
            data[offset:] + bytes(stride * h - (len(data) - offset)),
            np.uint8)
    rows = rows.reshape(h, stride)
    if direction == -1:
        rows = rows[::-1]
    kind, arg = layout
    if kind == "bgr24":
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    if kind == "bits16":
        px = rows[:, :2 * w].copy().view("<u2").reshape(h, w)
        return _bits16(px, arg)
    if kind == "masks32":
        px = rows[:, :4 * w].copy().view("<u4").reshape(h, w)
        r, g, b, _ = arg if arg != (0, 0, 0, 0) else (
            0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        return np.stack([(px >> (m.bit_length() - 8)) & 0xFF
                         for m in (r, g, b)], -1).astype(np.uint8)
    # palette indices at 1, 4 or 8 bits
    if grey and bits == 4:
        # Pillow reads this as 8-bit "L" samples: row y is the w bytes at
        # y * stride (running into the next rows), zeros past the file's end
        raw = data[offset:offset + (h - 1) * stride + w]
        raw = np.frombuffer(raw + bytes((h - 1) * stride + w - len(raw)),
                            np.uint8)
        g = raw[np.arange(h)[:, None] * stride + np.arange(w)]
        if direction == -1:
            g = g[::-1]
        return np.repeat(g[..., None], 3, axis=-1)
    if bits == 8:
        idx = rows[:, :w]
    else:
        bitsarr = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        idx = (bitsarr * weights).sum(axis=2, dtype=np.uint8)[:, :w]
    if grey:
        if bits == 1:  # Pillow's mode "1"
            return np.repeat((idx * np.uint8(255))[..., None], 3, axis=-1)
        return np.repeat(idx[..., None], 3, axis=-1)
    return table[idx]
