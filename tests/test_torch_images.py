"""The port's image readers (``data/images.py`` and the JPEG, PNG, BMP and
Netpbm readers under it) against the JAX package's loader, which reads
every image through Pillow (``epic_tpu.data.datasets._load_image``).

- Each case, written into a temporary directory, reads to exactly
  ``_load_image(path) * 255`` (``read_image``, uint8) and to
  ``_load_image(path)`` bit for bit (``load_image``, float32):
  JPEG files that Pillow writes (sizes off the MCU grid, 4:4:4 / 4:2:2 /
  4:2:0, progressive, optimized tables, restart markers, grey, Adobe CMYK)
  and files of a small baseline writer below (4:4:0, 4:1:1, mixed sampling,
  one scan per component, restart intervals, Adobe YCCK / RGB / CMYK,
  component ids 'R', 'G', 'B', 16-bit quantization tables under SOF1);
  PNG files of every colour type and bit depth, Adam7-interlaced or not;
  BMP files (palettes at 1 / 4 / 8 bits, a grey-ramp palette, 16 / 24 /
  32 bits, bit fields, RLE8 / RLE4, top-down, the OS/2 header); Netpbm
  P1-P6 at several maxvals.
- The committed fixtures (``tests/fixtures/images``, written by
  ``gen_torch_image_fixtures.py``) decode to Pillow's checksums.
- Progressive files that stop after any of their scans (block smoothing)
  and baseline files without DHT segments (the standard tables) read as
  the JAX package's.
- Each refused feature raises ValueError naming the file.
- ``ImageFolder`` + ``data_loader`` on a folder of mixed formats give the
  JAX package's batches bit for bit.
- ``cli.codec compress`` of a ``.jpg`` writes the same ``.epic`` bytes as
  of a PNG of that JPEG's Pillow-decoded pixels (tiny ``pic`` model).
"""

import hashlib
import io
import json
import os
import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image, ImageFile

from epic_tpu.data.datasets import ImageFolder as JImageFolder
from epic_tpu.data.datasets import _load_image as j_load_image
from epic_tpu.data.datasets import data_loader as j_data_loader
from epic_tpu_torch.cli import codec as cli
from epic_tpu_torch.data.datasets import ImageFolder, data_loader
from epic_tpu_torch.data.images import load_image, read_image
from epic_tpu_torch.data.jpeg import decode_jpeg
from epic_tpu_torch.data.png import write_png
from test_torch_train_step import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
ImageFile.MAXBLOCK = 1 << 22  # Pillow writes progressive JPEG in one go


def picture(h, w, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([0.5 + 0.35 * np.sin(xx / (3 + 2 * c) + seed)
                    * np.cos(yy / (4 + c)) for c in range(channels)], -1)
    img += 0.08 * rng.standard_normal(img.shape)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def assert_reads_as_jax(path):
    want = j_load_image(str(path))
    got = load_image(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(str(path)).astype(np.float32),
                                  want * np.float32(255.0))


# ---- a small baseline JPEG writer: samplings, scans and markers that
# Pillow's writer does not make ----

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8)
                  * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
                 for k in range(8)])
# every (run, size) symbol, EOB and ZRL first, with one 8-bit code each
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                           for s in range(1, 11)]


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def app_jfif():
    return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def app_adobe(transform):
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                 transform))


class _BitWriter:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value, bits):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def write_jpeg(planes, sampling, ids=None, interleaved=True, app=b"",
               sof=0xC0, qbits=8, restart=0, quant=4):
    """A baseline JPEG of component ``planes`` (uint8, each at its own
    resolution) with ``sampling`` [(h, v)], flat Huffman tables (4-bit DC
    and 8-bit AC codes) and one quantization table."""
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    height = max(-(-p.shape[0] * maxv // v)
                 for p, (_, v) in zip(planes, sampling))
    width = max(-(-p.shape[1] * maxh // h)
                for p, (h, _) in zip(planes, sampling))
    q = np.full(64, quant) if np.isscalar(quant) else np.asarray(quant)
    mx, my = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    blocks = []
    for p, (h, v) in zip(planes, sampling):
        pad = np.pad(p.astype(np.float64) - 128,
                     ((0, my * v * 8 - p.shape[0]),
                      (0, mx * h * 8 - p.shape[1])), mode="edge")
        b = pad.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ki,yxij,lj->yxkl", _DCT, b, _DCT)
        blocks.append(np.round(coef.reshape(my * v, mx * h, 64) / q)
                      .astype(np.int64)[..., _ZIGZAG])
    out = b"\xff\xd8" + app
    if qbits == 8:
        out += _segment(0xDB, bytes([0]) + bytes(int(v) for v in q[_ZIGZAG]))
    else:
        out += _segment(0xDB, bytes([0x10]) + b"".join(
            struct.pack(">H", int(v)) for v in q[_ZIGZAG]))
    out += _segment(sof, struct.pack(">BHHB", 8, height, width, nc)
                    + b"".join(bytes([i, (h << 4) | v, 0])
                               for i, (h, v) in zip(ids, sampling)))
    dc_counts = [0, 0, 0, 12] + [0] * 12
    ac_counts = [0] * 7 + [len(_AC_SYMS)] + [0] * 8
    out += _segment(0xC4, bytes([0x00] + dc_counts + list(range(12)))
                    + bytes([0x10] + ac_counts + _AC_SYMS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    code = {s: i for i, s in enumerate(_AC_SYMS)}

    def size(v):
        return int(abs(v)).bit_length()

    def put_block(bits, blk, pred):
        d = int(blk[0]) - pred
        bits.put(size(d), 4)
        if d:
            bits.put(d if d > 0 else d - 1, size(d))
        nz = np.flatnonzero(blk[1:])
        last = int(nz[-1]) + 1 if nz.size else 0
        run = 0
        for k in range(1, last + 1):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(code[0xF0], 8)
                run -= 16
            bits.put(code[(run << 4) | size(v)], 8)
            bits.put(v if v > 0 else v - 1, size(v))
            run = 0
        if last < 63:
            bits.put(code[0x00], 8)
        return int(blk[0])

    def scan(comps, units):
        seg = _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0]) for c in comps) + bytes([0, 63, 0]))
        bits, preds, rst = _BitWriter(), {c: 0 for c in comps}, 0
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                seg += bits.flush() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                bits, preds = _BitWriter(), {c: 0 for c in comps}
            for c, blk in unit:
                preds[c] = put_block(bits, blk, preds[c])
        return seg + bits.flush()

    if interleaved and nc > 1:
        out += scan(list(range(nc)), [
            [(c, blocks[c][y * sampling[c][1] + j, x * sampling[c][0] + i])
             for c in range(nc) for j in range(sampling[c][1])
             for i in range(sampling[c][0])]
            for y in range(my) for x in range(mx)])
    else:
        for c, (h, v) in enumerate(sampling):
            wib = -(-width * h // (8 * maxh))
            hib = -(-height * v // (8 * maxv))
            out += scan([c], [[(c, blocks[c][y, x])] for y in range(hib)
                              for x in range(wib)])
    return out + b"\xff\xd9"


def planes_for(height, width, sampling, seed):
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    return [picture(-(-height * v // maxv), -(-width * h // maxh),
                    seed + i, 1)[..., 0]
            for i, (h, v) in enumerate(sampling)]


YCC = {"420": [(2, 2), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
       "411": [(4, 1), (1, 1), (1, 1)], "mixed": [(2, 2), (1, 2), (2, 1)],
       "chroma_full": [(1, 1), (2, 2), (1, 1)]}
WRITER_CASES = {
    **{f"{k}_{'inter' if inter else 'scans'}_{h}x{w}":
       dict(planes=(h, w, s), interleaved=inter, app=app_jfif(),
            restart=3 if inter else 0)
       for k, s in YCC.items() for inter in (True, False)
       for h, w in ((45, 67), (9, 33))},
    "ycck": dict(planes=(45, 67, [(2, 2), (1, 1), (1, 1), (2, 2)]),
                 app=app_adobe(2)),
    "cmyk_adobe0": dict(planes=(33, 9, [(1, 1)] * 4), app=app_adobe(0)),
    "cmyk_no_adobe": dict(planes=(33, 9, [(1, 1)] * 4)),
    "rgb_adobe0": dict(planes=(45, 67, [(1, 1)] * 3), app=app_adobe(0)),
    "rgb_ids": dict(planes=(45, 67, [(1, 1)] * 3), ids=[82, 71, 66]),
    "ycc_odd_ids": dict(planes=(45, 67, [(1, 1)] * 3), ids=[5, 9, 2]),
    "sof1_16bit_tables": dict(planes=(45, 67, [(1, 1)] * 3), sof=0xC1,
                              qbits=16, quant=np.arange(1, 65) * 5),
    "grey_2x2": dict(planes=(17, 33, [(2, 2)])),
}


@pytest.mark.parametrize("name", sorted(WRITER_CASES))
def test_jpeg_writer_cases_read_as_jax(tmp_path, name):
    kw = dict(WRITER_CASES[name])
    h, w, sampling = kw.pop("planes")
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(write_jpeg(planes_for(h, w, sampling, len(name)),
                                sampling, **kw))
    assert_reads_as_jax(path)


PILLOW_JPEG = {
    f"{h}x{w}_s{s}_{mode}": ((h, w), dict(quality=q, subsampling=s, **kw))
    for h, w in ((1, 1), (45, 67), (16, 16), (17, 130))
    for s, q in ((0, 95), (1, 60), (2, 85))
    for mode, kw in (("base", {}), ("prog", {"progressive": True}),
                     ("opt", {"optimize": True}),
                     ("rst", {"restart_marker_blocks": 1}))}


@pytest.mark.parametrize("name", sorted(PILLOW_JPEG))
def test_pillow_jpeg_reads_as_jax(tmp_path, name):
    (h, w), kw = PILLOW_JPEG[name]
    path = tmp_path / f"{name}.jpg"
    Image.fromarray(picture(h, w, len(name))).save(path, "JPEG", **kw)
    assert_reads_as_jax(path)


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("progressive", [False, True])
def test_pillow_grey_and_cmyk_jpeg_read_as_jax(tmp_path, mode, progressive):
    path = tmp_path / f"{mode}.jpeg"
    Image.fromarray(picture(45, 67, 7)).convert(mode).save(
        path, "JPEG", quality=90, progressive=progressive)
    assert_reads_as_jax(path)


# ---- PNG ----

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_rows(samples, depth, seed):
    """Scanlines of samples [h, w, ch], each row filtered with None or
    Sub (chosen from ``seed``)."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    if depth >= 8:
        rows = (samples.astype(">u2").view(np.uint8) if depth == 16
                else samples.astype(np.uint8)).reshape(h, -1)
    else:
        per = 8 // depth
        stride = -(-w * ch // per)
        flat = np.zeros((h, stride * per), np.int64)
        flat[:, :w * ch] = samples.reshape(h, -1)
        shifts = 8 - depth * (np.arange(per) + 1)
        rows = (flat.reshape(h, stride, per) << shifts).sum(-1).astype(
            np.uint8)
    bpp = max(1, depth * ch // 8)
    out = b""
    for r in rows.astype(np.int64):
        if rng.integers(2):
            left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
            out += b"\x01" + ((r - left) % 256).astype(np.uint8).tobytes()
        else:
            out += b"\x00" + r.astype(np.uint8).tobytes()
    return out


def write_png_raw(path, samples, depth, colour, interlace, palette=None):
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(_png_rows(samples[y0::dy, x0::dx], depth, k)
                       for k, (x0, y0, dx, dy) in enumerate(_ADAM7)
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _png_rows(samples, depth, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                     int(interlace)))
        + (chunk(b"PLTE", bytes(palette)) if palette is not None else b"")
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


PNG_CASES = [(c, d, i) for c, depths in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                         3: (1, 2, 4, 8), 4: (8, 16),
                                         6: (8, 16)}.items()
             for d in depths for i in (False, True)]


@pytest.mark.parametrize("colour,depth,interlace", PNG_CASES)
def test_png_reads_as_jax(tmp_path, colour, depth, interlace):
    rng = np.random.default_rng(colour * 100 + depth)
    path = tmp_path / "x.png"
    for h, w in ((1, 1), (9, 13), (5, 33)):
        top = 1 << depth
        if depth == 16 and colour == 0:  # values on both sides of 255
            top = 600
        samples = rng.integers(0, top, (h, w, _PNG_CHANNELS[colour]))
        palette = (rng.integers(0, 256, 3 * 5) if colour == 3 else None)
        write_png_raw(path, samples, depth, colour, interlace, palette)
        assert_reads_as_jax(path)


# ---- BMP ----

def _bmp(w, h, bits, pixels, comp=0, palette=b"", masks=None,
         top_down=False, header=40, colors=0):
    extra = (struct.pack("<III", *masks[:3])
             if header == 40 and masks is not None else b"")
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (-h) & 0xFFFFFFFF if top_down else h
        hdr = struct.pack("<IIIHHIIiiII", header, w, hh, 1, bits, comp,
                          len(pixels), 2835, 2835, colors, 0)
        if header > 40:
            hdr += struct.pack("<IIII", *(list(masks or ()) + [0] * 4)[:4])
            hdr += bytes(header - 56)
    off = 14 + len(hdr) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + hdr + extra + palette + pixels)


def _bmp_rows(rows):
    return b"".join(r + bytes(-len(r) % 4) for r in rows)


def _packed(idx, bits):
    per = 8 // bits
    out = []
    for r in idx:
        b = bytearray(-(-len(r) // per))
        for x, v in enumerate(r):
            b[x // per] |= int(v) << (8 - bits * (x % per + 1))
        out.append(bytes(b))
    return out


def _rle8(idx):
    out = bytearray()
    for r in idx:
        x = 0
        while x < len(r):
            run = 1
            while x + run < len(r) and r[x + run] == r[x] and run < 255:
                run += 1
            if run >= 2 or len(r) - x < 3:
                out += bytes([run, r[x]])
                x += run
            else:  # an absolute run, padded to 16 bits
                k = min(len(r) - x, 255)
                out += bytes([0, k]) + bytes(int(v) for v in r[x:x + k])
                out += b"\0" * (k % 2)
                x += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(idx):
    out = bytearray()
    for r in idx:
        for x in range(0, len(r), 2):
            k = min(len(r) - x, 2)
            out += bytes([k, (int(r[x]) << 4)
                          | (int(r[x + 1]) if k > 1 else 0)])
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_cases():
    rng = np.random.default_rng(11)
    w, h = 13, 7
    cases = {}
    for bits in (1, 4, 8):
        n = 1 << bits
        idx = rng.integers(0, n, (h, w))
        rows = _packed(idx, bits) if bits < 8 else [
            bytes(r.astype(np.uint8)) for r in idx]
        pal = bytes(rng.integers(0, 256, 4 * n).astype(np.uint8))
        cases[f"pal{bits}"] = _bmp(w, h, bits, _bmp_rows(rows[::-1]),
                                   palette=pal)
        cases[f"pal{bits}_top_down"] = _bmp(w, h, bits, _bmp_rows(rows),
                                            palette=pal, top_down=True)
        cases[f"pal{bits}_two_colours"] = _bmp(
            w, h, bits, _bmp_rows(rows[::-1]), palette=pal[:8], colors=2)
        grey = b"".join(bytes([v, v, v, 0])
                        for v in ((0, 255) if n == 2 else range(n)))
        cases[f"pal{bits}_grey_ramp"] = _bmp(w, h, bits,
                                             _bmp_rows(rows[::-1]),
                                             palette=grey)
        cases[f"pal{bits}_os2"] = _bmp(
            w, h, bits, _bmp_rows(rows[::-1]), header=12,
            palette=bytes(rng.integers(0, 256, 3 * n).astype(np.uint8)))
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rows24 = [r[:, :3].tobytes() for r in px[::-1]]
    rows32 = [r.tobytes() for r in px[::-1]]
    p16 = rng.integers(0, 65536, (h, w)).astype("<u2")
    rows16 = [r.tobytes() for r in p16[::-1]]
    cases["rgb24"] = _bmp(w, h, 24, _bmp_rows(rows24))
    cases["rgb24_os2"] = _bmp(w, h, 24, _bmp_rows(rows24), header=12)
    cases["rgb32"] = _bmp(w, h, 32, _bmp_rows(rows32))
    cases["rgb16"] = _bmp(w, h, 16, _bmp_rows(rows16))
    for m in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
        for header in (40, 124):
            cases[f"bitfields16_{m[0]:x}_h{header}"] = _bmp(
                w, h, 16, _bmp_rows(rows16), comp=3, masks=m + (0,),
                header=header)
    for m in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
              (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
              (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)):
        cases[f"bitfields32_{m[0]:x}_{m[3]:x}"] = _bmp(
            w, h, 32, _bmp_rows(rows32), comp=3, masks=m, header=56)
    idx8 = np.repeat(rng.integers(0, 256, (h, 5)), 3, axis=1)[:, :w]
    cases["rle8"] = _bmp(w, h, 8, _rle8(idx8[::-1].astype(np.uint8)),
                         comp=1, palette=bytes(rng.integers(
                             0, 256, 1024).astype(np.uint8)))
    cases["rle4"] = _bmp(w, h, 4, _rle4(rng.integers(0, 16, (h, w))),
                         comp=2, palette=bytes(rng.integers(
                             0, 256, 64).astype(np.uint8)))
    return cases


BMP_CASES = bmp_cases()


@pytest.mark.parametrize("name", sorted(BMP_CASES))
def test_bmp_reads_as_jax(tmp_path, name):
    path = tmp_path / f"{name}.bmp"
    path.write_bytes(BMP_CASES[name])
    assert_reads_as_jax(path)


# ---- Netpbm ----

def ppm_cases():
    rng = np.random.default_rng(12)
    w, h = 13, 7
    cases = {}
    for maxval in (1, 100, 255, 1000, 65535):
        for bands, plain, raw in ((1, b"P2", b"P5"), (3, b"P3", b"P6")):
            v = rng.integers(0, maxval + 1, (h, w, bands))
            body = (v.astype(">u2").tobytes() if maxval > 255
                    else v.astype(np.uint8).tobytes())
            cases[f"{raw.decode()}_{maxval}"] = (
                b"%s\n# comment\n%d %d\n%d\n" % (raw, w, h, maxval) + body)
            cases[f"{plain.decode()}_{maxval}"] = (
                b"%s %d %d %d\n" % (plain, w, h, maxval)
                + b" ".join(b"%d" % x for x in v.ravel()) + b"\n")
    bits = rng.integers(0, 2, (h, w))
    cases["P1"] = b"P1\n%d %d\n" % (w, h) + b"".join(
        b"%d" % x for x in bits.ravel())
    cases["P4"] = b"P4\n%d %d\n" % (w, h) + np.packbits(bits, 1).tobytes()
    return cases


PPM_CASES = ppm_cases()


@pytest.mark.parametrize("name", sorted(PPM_CASES))
def test_ppm_reads_as_jax(tmp_path, name):
    path = tmp_path / f"{name}.ppm"
    path.write_bytes(PPM_CASES[name])
    assert_reads_as_jax(path)


# ---- committed fixtures, refusals, the loader, the CLI ----

def test_fixtures_match_pillow_checksums():
    with open(os.path.join(FIXTURES, "checksums.json")) as f:
        sums = json.load(f)
    assert len(sums) >= 24
    for name, digest in sums.items():
        got = read_image(os.path.join(FIXTURES, name))
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()
                              ).hexdigest() == digest, name
        assert_reads_as_jax(os.path.join(FIXTURES, name))


def _with_marker(data, old, new):
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def refused_files():
    buf = io.BytesIO()
    Image.fromarray(picture(32, 48, 3)).save(buf, "JPEG", quality=80)
    jpg = buf.getvalue()
    sof = jpg.index(b"\xff\xc0")
    twelve = jpg[:sof + 4] + b"\x0c" + jpg[sof + 5:]
    # a scan naming Huffman table 2, which no DHT segment defines (only
    # slots 0 and 1 have standard tables to fall back on)
    sos = jpg.index(b"\xff\xda")
    no_table = jpg[:sos + 6] + b"\x22" + jpg[sos + 7:]
    two_comp = write_jpeg(planes_for(16, 16, [(1, 1)] * 2, 0), [(1, 1)] * 2)
    return {
        "arith.jpg": (_with_marker(jpg, 0xC0, 0xC9), "arithmetic coding"),
        "lossless.jpg": (_with_marker(jpg, 0xC0, 0xC3), "lossless"),
        "hierarchical.jpg": (_with_marker(jpg, 0xC0, 0xC5), "hierarchical"),
        "twelve.jpg": (twelve, "12-bit samples"),
        "two.jpg": (two_comp, "2-component"),
        "half.jpg": (jpg[:len(jpg) // 2], "truncated"),
        "no_eoi.jpg": (jpg[:-2], "truncated"),
        "no_table.jpg": (no_table, "without its Huffman table"),
        "bad_depth.png": (None, "bit depth 4 and colour type 2"),
        "jpeg_in.bmp": (_bmp(4, 4, 24, bytes(64), comp=4), "compression 4"),
        "fields.bmp": (_bmp(4, 4, 32, bytes(64), comp=3,
                            masks=(0xFF, 0xFF00, 0xFF0000, 0), header=56),
                       "bitfields"),
        "float.pfm": (b"Pf 2 2 -1.0\n" + bytes(16), "Pf"),
        "anim.gif": (b"GIF89a" + bytes(20), "not a JPEG, PNG, BMP"),
    }


REFUSED = refused_files()


def _smoothing_cases():
    """Progressive files of Pillow cut after each of their scans but the
    last (EOI kept), which libjpeg-turbo block-smooths, and baseline files
    without DHT segments (the standard tables apply): {id: (image, save
    options, kind, scans kept)}."""
    cases = {}
    for sub, name in ((2, "420"), (1, "422"), (0, "444"), (None, "grey")):
        img = (Image.fromarray(picture(37, 53, 5)).convert("L") if sub is None
               else Image.fromarray(picture(37, 53, 5)))
        kw = dict(quality=80, progressive=True)
        if sub is not None:
            kw["subsampling"] = sub
        buf = io.BytesIO()
        img.save(buf, "JPEG", **kw)
        n = buf.getvalue().count(b"\xff\xda")
        for keep in range(1, n):
            cases[f"progressive{name}_first{keep}"] = (img, kw, "cut", keep)
        cases[f"nodht_{name}"] = (img, dict(quality=85, optimize=False,
                                            subsampling=sub or 0,
                                            restart_marker_blocks=3),
                                  "nodht", 0)
    return cases


SMOOTHING = _smoothing_cases()


@pytest.mark.parametrize("name", sorted(SMOOTHING))
def test_smoothed_and_tableless_jpeg_read_as_jax(tmp_path, name):
    from gen_torch_image_fixtures import first_scans, strip_dht

    img, kw, kind, keep = SMOOTHING[name]
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    data = buf.getvalue()
    data = first_scans(data, keep) if kind == "cut" else strip_dht(data)
    if kind == "nodht":
        assert b"\xff\xc4" not in data
    path = tmp_path / (name + ".jpg")
    path.write_bytes(data)
    assert_reads_as_jax(path)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_feature_raises_with_file_name(tmp_path, name):
    data, feature = REFUSED[name]
    path = tmp_path / name
    if data is None:
        write_png_raw(path, np.zeros((2, 2, 3), np.int64), 4, 2, False)
    else:
        path.write_bytes(data)
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*"
                       + re.escape(feature)):
        read_image(str(path))


def test_jpeg_threads_decode_alike():
    """The ctypes call releases the GIL: a pool decodes the 768x512
    fixtures to the one-thread result."""
    data = [open(os.path.join(FIXTURES, n), "rb").read()
            for n in ("photo768_baseline.jpg", "photo768_progressive.jpg")]
    want = [decode_jpeg(d) for d in data]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(decode_jpeg, data * 4))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % 2])


def test_mixed_folder_batches_equal_jax(tmp_path):
    root = tmp_path / "train"
    root.mkdir()
    for i, (name, save) in enumerate((
            ("a.jpg", dict(format="JPEG", quality=85)),
            ("b.png", dict(format="PNG")),
            ("c.jpeg", dict(format="JPEG", quality=70, progressive=True)),
            ("d.bmp", dict(format="BMP")),
            ("e.ppm", dict(format="PPM")),
            ("f.jpg", dict(format="JPEG", subsampling=0)))):
        h, w = (40, 56) if i % 2 else (24, 70)  # some below the patch
        Image.fromarray(picture(h, w, i)).save(root / name, **save)
    # a JPEG under a PNG name: both readers go by the file's bytes
    Image.fromarray(picture(36, 36, 9)).save(root / "g.png", "JPEG")
    ds, jds = ImageFolder(str(tmp_path), "train", 32), JImageFolder(
        str(tmp_path), "train", 32)
    assert ds.paths == jds.paths and len(ds.paths) == 7
    for got, want in zip(data_loader(ds, 4, seed=5, steps=3),
                         j_data_loader(jds, 4, seed=5, steps=3)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_codec_cli_jpeg_equals_png_of_its_pixels(tmp_path):
    jpg, png = str(tmp_path / "photo.jpg"), str(tmp_path / "photo.png")
    Image.fromarray(picture(64, 64, 4)).save(jpg, "JPEG", quality=80,
                                            subsampling=2)
    with Image.open(jpg) as im:
        write_png(png, np.asarray(im.convert("RGB")))
    outs = []
    for src in (jpg, png):
        out = str(tmp_path / (os.path.basename(src) + ".epic"))
        cli.main(["compress", src, out, "--tiny", "--model", "pic",
                  "--q_levs", "0.5", "10", "--device", "cpu"])
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
