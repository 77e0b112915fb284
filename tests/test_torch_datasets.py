"""The port's host data path and the training CLI's helpers against the JAX
package's, on the CPU, with no JAX program compiled.

- ``data_loader(ImageFolder(...))``: batches bitwise the JAX package's for
  the same folder of PNGs (written by Pillow with its default filters:
  RGB, one grey, one palette, one smaller than the patch) and seed, over
  enough batches to wrap the shuffle twice; ``ImageFolder``'s three split
  resolutions and ``TestImageDataset``'s order and images;
  ``_validation_split``'s three cases with the JAX CLI's paths.
- ``parse_train_args`` / ``model_config_from_args`` (pic / rem / cnn) equal
  to the JAX package's, ``--device`` aside; the anchors; the metrics
  logger's JSONL record; ``sec_to_hours``; a device trace; the RD plot
  tool.
- ``read_png`` of palette PNGs (bit depths 1 / 2 / 4 / 8, a palette
  shorter than the indices) equal to Pillow's ``convert("RGB")``; a listed
  ``.jpg`` whose coding the reader refuses raises with the file's name.
"""

import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from epic_tpu.cli.train import _validation_split as j_validation_split
from epic_tpu.data import datasets as jds
from epic_tpu.utils import comparison as jcomparison
from epic_tpu.utils import parser as jparser
from epic_tpu.utils.profiling import sec_to_hours as j_sec_to_hours
from epic_tpu_torch.cli.train import _validation_split
from epic_tpu_torch.data import ImageFolder, data_loader
from epic_tpu_torch.data import datasets as pds
from epic_tpu_torch.data.png import read_png
from epic_tpu_torch.utils import comparison, parser
from epic_tpu_torch.utils.logging import MetricsLogger
from epic_tpu_torch.tools import plot_rd
from epic_tpu_torch.utils.profiling import Timers, device_trace, sec_to_hours

PATCH = 48


def _rgb(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 7 + yy / 11),
                    0.5 + 0.4 * np.cos(xx / 5 - yy / 9), (xx + yy) / (h + w)],
                   -1) + rng.normal(0, 0.05, (h, w, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _palette_image(rng, h, w, colours):
    im = Image.fromarray(rng.integers(0, colours, (h, w)).astype(np.uint8),
                         "P")
    im.putpalette(rng.integers(0, 256, 3 * colours).astype(np.uint8)
                  .tobytes())
    return im


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """root/train/data: 5 RGB images of several sizes, one grey, one
    palette, one smaller than the patch; root/test/data: 2 images; a flat
    kodak directory of 3."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(11)
    train = root / "train" / "data"
    train.mkdir(parents=True)
    for i, (h, w) in enumerate([(64, 80), (72, 64), (96, 50), (50, 96),
                                (60, 60)]):
        Image.fromarray(_rgb(rng, h, w)).save(train / f"im{i}.png")
    Image.fromarray(_rgb(rng, 70, 66)[..., 0]).save(train / "grey.png")
    _palette_image(rng, 66, 70, 200).save(train / "palette.png")
    Image.fromarray(_rgb(rng, 40, 30)).save(train / "small.png")
    (train / "notes.txt").write_text("not an image")
    test = root / "test" / "data"
    test.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(_rgb(rng, 64, 64)).save(test / f"v{i}.png")
    kodak = root / "kodak"
    kodak.mkdir()
    for name in ("b.png", "a.png", "c.png"):
        Image.fromarray(_rgb(rng, 64, 96)).save(kodak / name)
    return root


def test_batches_equal_jax(folder):
    port = ImageFolder(str(folder), "train", PATCH)
    ref = jds.ImageFolder(str(folder), "train", PATCH)
    assert port.paths == ref.paths and len(port) == 8
    # 6 batches of 3 draw 18 images from 8: the shuffle wraps twice
    got = list(data_loader(port, 3, seed=5, steps=6))
    want = list(jds.data_loader(ref, 3, seed=5, steps=6))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (3, PATCH,
                                                                PATCH, 3)
        np.testing.assert_array_equal(g, w)
    other = next(data_loader(port, 3, seed=6, steps=1))
    assert not np.array_equal(other, got[0])


@pytest.mark.parametrize("layout", ["split/data", "split", "root"])
def test_split_resolution(tmp_path, layout):
    base = {"split/data": tmp_path / "train" / "data",
            "split": tmp_path / "train", "root": tmp_path}[layout]
    base.mkdir(parents=True, exist_ok=True)
    for i in range(3):
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
            base / f"x{i}.png")
    port = ImageFolder(str(tmp_path), "train", 8, num_images=2)
    assert port.paths == jds.ImageFolder(str(tmp_path), "train", 8, 2).paths
    assert [os.path.dirname(p) for p in port.paths] == [str(base)] * 2


def test_test_dataset_order_and_images(folder):
    port = list(pds.TestImageDataset(str(folder / "kodak")))
    ref = list(jds.TestImageDataset(str(folder / "kodak")))
    assert [p for _, p in port] == [p for _, p in ref]
    assert [os.path.basename(p) for _, p in port] == ["a.png", "b.png",
                                                      "c.png"]
    for (a, _), (b, _) in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert len(pds.TestImageDataset(str(folder / "kodak"), num_images=2)) == 2


def _flat_folder(tmp_path, n):
    d = tmp_path / "train" / "data"
    d.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(np.full((8, 8, 3), i * 7 % 255, np.uint8)).save(
            d / f"im{i:02d}.png")
    return str(tmp_path)


@pytest.mark.parametrize("case", ["test_split", "carve", "single"])
def test_validation_split_matches_jax(tmp_path, folder, capsys, case):
    """The JAX CLI's tests/test_cli_train.py::TestValidationSplit cases,
    with the same paths as the JAX package's split."""
    if case == "test_split":
        root, patch = str(folder), PATCH
    else:
        root, patch = _flat_folder(tmp_path, 12 if case == "carve" else 1), 8
    train_out, valid = _validation_split(ImageFolder(root, "train", patch),
                                         root, patch, None)
    err = capsys.readouterr().err
    j_train, j_valid = j_validation_split(jds.ImageFolder(root, "train",
                                                          patch),
                                          root, patch, None)
    assert train_out.paths == j_train.paths
    assert valid.paths == j_valid.paths
    if case == "test_split":
        assert len(train_out.paths) == 8 and err == ""
        assert {os.path.basename(os.path.dirname(os.path.dirname(p)))
                for p in valid.paths} == {"test"}
    elif case == "carve":
        assert len(valid.paths) == 1 and len(train_out.paths) == 11
        assert not set(valid.paths) & set(train_out.paths)
        assert "held out the last 1" in err
    else:
        assert valid is train_out and "only one train image" in err


@pytest.mark.parametrize("argv", [
    [], ["--model", "rem", "--check_levels", "0.25", "0.75", "--dimension",
         "middle", "--no_mu_std"],
    ["--model", "cnn", "--N", "128", "--dim_chunk", "16"],
    ["--N", "16", "--M", "32", "--division_dimension", "16", "32",
     "--param_net_widths", "24", "16", "--no_multiple_encoder",
     "--training_type", "rems", "--lrp", "--eval_every", "3"]])
def test_train_args_and_config_match_jax(argv):
    port = parser.parse_train_args(argv + ["--device", "cpu"])
    ref = jparser.parse_train_args(argv)
    got = vars(port)
    assert got.pop("device") == "cpu"
    assert got == vars(ref)
    assert parser.model_config_from_args(port) == \
        jparser.model_config_from_args(ref)
    assert parser.parse_train_args(argv).device is None


def test_anchors_logger_and_timers(tmp_path):
    assert comparison.load_anchors() == jcomparison.load_anchors()
    assert comparison.anchor("reference_pic") == \
        jcomparison.anchor("reference_pic")
    lg = MetricsLogger(str(tmp_path))
    lg.log({"loss": 1.5, "bpp": np.float32(0.3)}, step=7)
    lg.close()
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.read())
    assert rec["step"] == 7 and abs(rec["bpp"] - 0.3) < 1e-6
    for s in (0.0, 59.994, 3725.5, 90061.25):
        assert sec_to_hours(s) == j_sec_to_hours(s)
    timers = Timers()
    for _ in range(2):
        with timers.time("load"):
            pass
    assert timers.summary()["load"]["count"] == 2
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        np.sort(np.arange(10))
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_plot_rd_tool(tmp_path, capsys):
    ev = {"checkpoint": "artifacts/ckpt_x/last@8",
          "real_bpp": [0.1, 0.2, 0.4], "psnr": [28.0, 30.5, 33.0]}
    path = tmp_path / "eval.json"
    path.write_text(json.dumps(ev))
    out = plot_rd.main([str(path), "--out", str(tmp_path / "rd.png")])
    assert capsys.readouterr().out.strip() == out == str(tmp_path / "rd.png")
    assert os.path.getsize(out) > 0


def _palette_png(path, idx, depth, palette):
    """A palette PNG of ``depth``-bit indices, written by hand: every row
    with the Sub filter (bytewise, one byte back)."""
    h, w = idx.shape
    per = 8 // depth
    packed = np.zeros((h, (w + per - 1) // per), np.uint8)
    for x in range(w):
        packed[:, x // per] |= (idx[:, x] << (8 - depth * (x % per + 1))
                                ).astype(np.uint8)
    sub = packed.astype(np.int16)
    sub[:, 1:] -= packed[:, :-1]
    rows = np.concatenate([np.ones((h, 1), np.uint8),
                           (sub & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 3, 0,
                                             0, 0))
                + chunk(b"PLTE", bytes(palette))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_matches_pillow(tmp_path, depth):
    rng = np.random.default_rng(depth)
    colours = 1 << depth
    for w in (1, 13, 64):  # rows that end inside a byte
        # Pillow's writer picks the bit depth from the palette's size
        path = tmp_path / f"pillow{w}.png"
        _palette_image(rng, 9, w, colours).save(path)
        with Image.open(path) as im:
            assert im.mode == "P"
            np.testing.assert_array_equal(read_png(str(path)),
                                          np.asarray(im.convert("RGB")))
    # Sub-filtered rows, and indices past a palette of 3 entries (black)
    path = tmp_path / "sub.png"
    _palette_png(path, rng.integers(0, colours, (5, 11)), depth,
                 rng.integers(0, 256, 9).astype(np.uint8))
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_png(str(path)),
                                      np.asarray(im.convert("RGB")))


def test_jpeg_raises_with_its_name(tmp_path):
    """A JPEG whose coding the reader refuses (arithmetic) raises with the
    file's name from inside the loader; a Huffman-coded one loads."""
    buf = io.BytesIO()
    Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(buf, "JPEG")
    data = buf.getvalue()
    sof = data.index(b"\xff\xc0")
    (tmp_path / "photo.jpg").write_bytes(data[:sof + 1] + b"\xc9"
                                         + data[sof + 2:])
    ds = ImageFolder(str(tmp_path), "train", 32)
    assert [os.path.basename(p) for p in ds.paths] == ["photo.jpg"]
    with pytest.raises(ValueError, match=r"photo\.jpg.*arithmetic coding"):
        next(data_loader(ds, 1, steps=1))
    (tmp_path / "photo.jpg").write_bytes(data)
    assert next(data_loader(ds, 1, steps=1)).shape == (1, 32, 32, 3)
