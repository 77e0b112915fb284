"""Write the image fixtures of ``tests/test_torch_images.py`` and
chip_smoke.py's phase 18 into ``tests/fixtures/images/``, with the SHA-256
of each file's decode by Pillow (``np.asarray(Image.open(p).convert("RGB"))``,
uint8 [H, W, 3] C-order bytes) in ``checksums.json``.

The pictures are seeded numpy images; Pillow writes the JPEG, BMP and PPM
files and the 1-bit PNG. Five JPEG files are Pillow's with a change of
bytes: two without their DHT segments (the standard tables apply) and three
progressive ones cut after their first scans (block smoothing applies). Pillow's PNG writer has no interlace and no 16-bit
RGB, so those two PNG files are written by ``write_png`` below (zlib and
numpy), and Pillow's decode of them gives their checksums all the same.

Not collected by pytest. Regenerate with:

    python tests/gen_torch_image_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
from PIL import Image, ImageFile

HERE = os.path.dirname(os.path.abspath(__file__))
DIR = os.path.join(HERE, "fixtures", "images")
CHECKSUMS = os.path.join(DIR, "checksums.json")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the 768x512 JPEG files that phase 18 times and builds its folder from
TIMED = ("photo768_baseline.jpg", "photo768_progressive.jpg")


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 [h, w, 3]: smooth colour waves, a few hard edges and a little
    noise, like a photograph's mix of flat and busy regions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(6, 60, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([0.5 + 0.3 * np.sin(xx / f[c, 0] + ph[c])
                    * np.cos(yy / f[c, 1]) for c in range(3)], -1)
    img += 0.15 * (((xx - w / 2) ** 2 + (yy - h / 3) ** 2)
                   < (min(h, w) / 4) ** 2)[..., None]
    img += 0.02 * rng.standard_normal(img.shape)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def write_png(path: str, samples: np.ndarray, depth: int, colour: int,
              interlace: bool = False) -> None:
    """samples [h, w, channels] of ``depth`` bits (8 or 16) -> a PNG file,
    filter 1 (Sub) on every row, Adam7 when ``interlace``."""
    h, w, ch = samples.shape
    bpp = ch * depth // 8

    def scanlines(sub: np.ndarray) -> bytes:
        rows = (sub.astype(">u2").view(np.uint8) if depth == 16
                else sub.astype(np.uint8)).reshape(sub.shape[0], -1)
        rows = rows.astype(np.int64)
        left = np.concatenate([np.zeros((rows.shape[0], bpp), np.int64),
                               rows[:, :-bpp]], axis=1)
        out = ((rows - left) % 256).astype(np.uint8)
        return b"".join(b"\x01" + r.tobytes() for r in out)

    if interlace:
        raw = b"".join(scanlines(samples[y0::dy, x0::dx])
                       for x0, y0, dx, dy in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = scanlines(samples)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, int(interlace)))
                + chunk(b"IDAT", zlib.compress(raw, 9))
                + chunk(b"IEND", b""))


def segments(data: bytes):
    """(marker, start, end) of each segment after SOI; a scan's segment
    runs to the marker after its entropy-coded data."""
    out, i = [], 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xD9:
            out.append((m, i, i + 2))
            break
        j = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if m == 0xDA:
            while not (data[j] == 0xFF and data[j + 1] != 0
                       and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
        out.append((m, i, j))
        i = j
    return out


def strip_dht(data: bytes) -> bytes:
    """The JPEG file without its DHT segments."""
    return data[:2] + b"".join(data[a:b] for m, a, b in segments(data)
                               if m != 0xC4)


def first_scans(data: bytes, keep: int) -> bytes:
    """The JPEG file cut before its scan number ``keep`` (from 0), EOI
    kept."""
    starts = [a for m, a, _ in segments(data) if m == 0xDA]
    return data[:starts[keep]] + b"\xff\xd9"


def pillow_sha256(path: str) -> str:
    with Image.open(path) as im:
        a = np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))
    return hashlib.sha256(a.tobytes()).hexdigest()


def main():
    ImageFile.MAXBLOCK = 1 << 24  # progressive / optimized JPEG in one go
    os.makedirs(DIR, exist_ok=True)
    small = picture(48, 64, 1)
    odd = picture(45, 67, 2)
    big = picture(512, 768, 3)
    jpeg = {
        "baseline444.jpg": (small, dict(quality=90, subsampling=0)),
        "baseline422.jpg": (small, dict(quality=90, subsampling=1)),
        "baseline420.jpg": (small, dict(quality=90, subsampling=2)),
        "progressive420.jpg": (small, dict(quality=85, progressive=True)),
        "optimized420.jpg": (small, dict(quality=85, optimize=True)),
        "restart420.jpg": (small, dict(quality=85,
                                       restart_marker_blocks=2)),
        "odd67x45_420.jpg": (odd, dict(quality=80)),
        "odd67x45_progressive.jpg": (odd, dict(quality=80,
                                               progressive=True)),
        "grey.jpg": (Image.fromarray(small).convert("L"), dict(quality=90)),
        "cmyk.jpg": (Image.fromarray(small).convert("CMYK"),
                     dict(quality=90)),
        TIMED[0]: (big, dict(quality=85)),
        TIMED[1]: (big, dict(quality=85, progressive=True)),
    }
    for name, (img, kw) in jpeg.items():
        im = img if isinstance(img, Image.Image) else Image.fromarray(img)
        im.save(os.path.join(DIR, name), "JPEG", **kw)
    # C-10 (a): baseline files without DHT segments (Pillow's tables with
    # optimize=False are the standard ones that the decoder falls back on)
    for name, img in (("nodht_420.jpg", odd),
                      ("nodht_grey.jpg", Image.fromarray(small).convert("L"))):
        im = img if isinstance(img, Image.Image) else Image.fromarray(img)
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=85, optimize=False)
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(strip_dht(buf.getvalue()))
    # C-10 (b): progressive files cut after their first scans (EOI kept),
    # which libjpeg-turbo block-smooths: the DC scan alone (4:2:0), the
    # first five scans (4:2:0), and all but the three last AC refinement
    # scans (4:4:4)
    for name, img, sub, keep in (("smooth_dc420.jpg", odd, 2, 1),
                                 ("smooth_ac420.jpg", odd, 2, 5),
                                 ("smooth_norefine444.jpg", small, 0, 7)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=80, progressive=True,
                                  subsampling=sub)
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(first_scans(buf.getvalue(), keep))
    write_png(os.path.join(DIR, "interlaced_rgb8.png"), odd, 8, 2,
              interlace=True)
    write_png(os.path.join(DIR, "rgb16.png"),
              odd.astype(np.uint16) * 257 + np.arange(67, dtype=np.uint16)[
                  None, :, None], 16, 2)
    Image.fromarray(odd[..., 0] > 120).save(os.path.join(DIR, "grey1.png"))
    Image.fromarray(small).convert("P").save(os.path.join(DIR, "pal8.bmp"))
    Image.fromarray(np.concatenate(
        [small, small[..., :1]], -1), "RGBA").save(
        os.path.join(DIR, "rgba32.bmp"))
    Image.fromarray(odd[..., 1]).save(os.path.join(DIR, "grey.pgm"))
    Image.fromarray(odd).save(os.path.join(DIR, "rgb.ppm"))
    sums = {name: pillow_sha256(os.path.join(DIR, name))
            for name in sorted(os.listdir(DIR)) if name != "checksums.json"}
    with open(CHECKSUMS, "w") as f:
        json.dump(sums, f, indent=1)
    total = sum(os.path.getsize(os.path.join(DIR, n)) for n in os.listdir(DIR))
    print(f"wrote {len(sums)} files, {total} bytes, into {DIR}")


if __name__ == "__main__":
    main()
