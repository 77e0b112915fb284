"""The port's image files, file codec, demo and RD evaluation against the
JAX package, on the CPU.

- ``data/png.py`` against Pillow: RGB, RGBA, L and LA files that Pillow
  writes, and files whose rows use each of the five filter types, read to
  equal pixels (``.convert("RGB")``); the writer's file read back equal by
  both; palette, 1-bit and 16-bit grey files read as Pillow reads them, an
  invalid bit depth refused.
- ``resize_lanczos`` equal to Pillow's ``resize(..., LANCZOS)``, which the
  teaser loader used.
- ``cli.codec`` on a tiny ``rem`` and a tiny ``cnn`` checkpoint directory
  (weights drawn with numpy into the JAX tree, as the other parity tests
  draw them, written once by the port, read by both packages; the
  entropy bottleneck's constructor weights, which ``init_weights(0)``
  keeps, give z tables that differ by one count between the packages,
  ROADMAP C-5, held in ``test_torch_entropy.py``): the ``.epic`` bytes
  equal the JAX CLI's; each package decompresses the other's file (the
  same bytes), at the top level and at level 0, to pixels that differ by
  at most one step in at most 1e-4 of them (float32 reconstructions within
  1e-5, truncated to uint8); ``info`` runs. The JAX CLI's codec is built once per checkpoint.
- ``cli.demo`` of the port on the tiny ``pic`` and ``cnn`` models
  (``--tiny``): the progressive demo's per-level rate non-decreasing,
  PSNR finite, its container and ``--save_recon`` PNGs written; WACNN's
  buffered coding.
- ``rd_sweep`` and ``compress_with_ac`` on the tiny ``rem`` model with
  REMs: per-level bpp equal to the JAX package's, PSNR and MS-SSIM (dB)
  within 1e-4 dB (float32 reconstructions within 1e-5 of each other).
"""

import json
import struct
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import epic_tpu.cli.codec as jcli
from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.models import get_model as j_get_model
from epic_tpu.training import load_checkpoint as j_load_checkpoint
from epic_tpu.training.evaluate import compress_with_ac as j_compress_with_ac
from epic_tpu.training.evaluate import rd_sweep as j_rd_sweep
from epic_tpu_torch import (PICCodec, from_jax_params, get_model,
                            load_checkpoint)
from epic_tpu_torch.cli import codec as cli
from epic_tpu_torch.cli import demo
from epic_tpu_torch.data.device_bank import resize_lanczos
from epic_tpu_torch.data.png import load_image, read_png, write_png
from epic_tpu_torch.training.checkpoint import save_checkpoint
from epic_tpu_torch.training.evaluate import compress_with_ac, rd_sweep
from test_torch_layers import random_params
from test_torch_train_step import one_torch_thread  # noqa: F401

TINY = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))
CONFIGS = {"rem": dict(TINY, check_levels=(0.25, 0.75),
                       rem_dimension="middle"),
           "cnn": dict(TINY, division=(32, 32))}
Q_LEVS = ["0.1", "0.5", "1", "10"]


def _photo(h=180, w=190, seed=1):
    """A smooth uint8 image with noise, sized off the 64 grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([0.5 + 0.4 * np.sin(xx / (9 + 4 * k)) * np.cos(yy / 7)
                     for k in range(3)], -1)
    return np.clip(np.round((base + 0.05 * rng.standard_normal(base.shape))
                            * 255), 0, 255).astype(np.uint8)


# ---- PNG files ----

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(path, px, colour):
    """An 8-bit PNG of px [H, W, C] whose row y uses filter y % 5."""
    h, w, ch = px.shape
    lines = px.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        cur = lines[y]
        prior = lines[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        kind = y % 5
        pred = [0, left, prior, (left + prior) // 2,
                _paeth(left, prior, upleft)][kind]
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(b"".join(out)))
                + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,colour", [("RGB", 2), ("RGBA", 6), ("L", 0),
                                         ("LA", 4)])
def test_png_reader_matches_pillow(tmp_path, mode, colour):
    rng = np.random.default_rng(colour)
    ch = len(mode)
    px = np.concatenate([_photo(37, 41, colour),
                         (rng.random((37, 41, 3)) * 255).astype(np.uint8)],
                        -1)[..., :max(ch, 1)]
    px = px[..., :ch]
    for name, write in (("pillow", lambda p: Image.fromarray(
            px if ch > 1 else px[..., 0], mode).save(p)),
                        ("filters", lambda p: _filtered_png(p, px,
                                                            colour))):
        path = str(tmp_path / f"{name}.png")
        write(path)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        got = read_png(path)
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            load_image(path), want.astype(np.float32) / 255.0)


def test_png_writer_round_trip_and_refusals(tmp_path):
    px = _photo(33, 47)
    write_png(str(tmp_path / "w.png"), px)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), px)
    with Image.open(tmp_path / "w.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), px)
    # palette, 1-bit grey and 16-bit grey files are read as Pillow's
    # convert("RGB") gives them; a bit depth the format does not allow
    # is refused
    Image.fromarray(px).convert("P").save(tmp_path / "p.png")
    Image.fromarray(px[..., 0] > 128).save(tmp_path / "b1.png")
    Image.fromarray((px[..., 0].astype(np.uint16) * 3)).save(
        tmp_path / "g16.png")
    for name in ("p.png", "b1.png", "g16.png"):
        with Image.open(tmp_path / name) as im:
            np.testing.assert_array_equal(read_png(str(tmp_path / name)),
                                          np.asarray(im.convert("RGB")))
    bad = bytearray((tmp_path / "w.png").read_bytes())
    bad[24] = 4  # IHDR bit depth 4 with colour type 2 (RGB)
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])))
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="bit depth 4"):
        read_png(str(tmp_path / "bad.png"))
    big = np.stack([_photo(120, 150, s)[..., 0] for s in range(3)], -1)
    for s in (0.75, 0.5):
        w, h = int(150 * s), int(120 * s)
        want = np.asarray(Image.fromarray(big).resize((w, h),
                                                      Image.LANCZOS))
        np.testing.assert_array_equal(resize_lanczos(big, w, h), want)


# ---- the file codec, across packages ----

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The image file and one checkpoint directory per model, written by
    the port; the JAX CLI's codec of each, built once."""
    root = tmp_path_factory.mktemp("cli")
    img = str(root / "img.png")
    write_png(img, _photo())
    ckpts, jcodecs = {}, {}
    for name, cfg in CONFIGS.items():
        ckpts[name] = str(root / name)
        shapes = jax.eval_shape(lambda: j_get_model(name, **cfg).init(
            {"params": jax.random.key(0), "noise": jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), method="init_all"))["params"]
        model = get_model(name, **cfg)
        model.load_state_dict(from_jax_params(
            random_params(dict(shapes), seed=5), model))
        save_checkpoint(ckpts[name], model,
                        {k: list(v) if isinstance(v, tuple) else v
                         for k, v in dict(cfg, model=name).items()}, step=1)
        jm, jp, _, _ = j_load_checkpoint(ckpts[name])
        jcodecs[ckpts[name]] = JPICCodec(jm, {"params": jp})
    return root, img, ckpts, jcodecs


@pytest.fixture
def jax_cli(files, monkeypatch):
    """The JAX package's CLI with its codec built once per checkpoint and
    its compile cache in the test's directory."""
    root, _, _, jcodecs = files
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(root / "jax_cache"))
    monkeypatch.setattr(jcli, "_build_codec",
                        lambda args: jcodecs[args.checkpoint])
    return jcli


@pytest.mark.parametrize("name", ["rem", "cnn"])
def test_codec_cli_matches_jax(files, jax_cli, name, capsys):
    root, img, ckpts, _ = files
    ck = ["--checkpoint", ckpts[name]]
    mine, theirs = str(root / f"{name}.epic"), str(root / f"{name}_j.epic")
    cli.main(["compress", img, mine, "--q_levs", *Q_LEVS, "--device", "cpu",
              *ck])
    jax_cli.main(["compress", img, theirs, "--q_levs", *Q_LEVS, *ck])
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    bs = cli.main(["info", mine])
    assert bs["meta"]["orig_size"] == [180, 190]
    assert bool(bs["meta"].get("single")) == (name == "cnn")
    if name == "rem":
        assert bs["meta"]["rems"] and len(bs["ckpt_streams"]) == 2
    for level in ([-1, 0] if name == "rem" else [-1]):
        lv = ["--level", str(level)]
        a, b = str(root / "a.png"), str(root / "b.png")
        got = cli.main(["decompress", theirs, a, "--device", "cpu", *ck,
                        *lv])
        jax_cli.main(["decompress", mine, b, *ck, *lv])
        np.testing.assert_array_equal(read_png(a), got)
        # the reconstructions agree within 1e-5 in float32; the truncation
        # to uint8 moves a pixel by one step where one lies that close to
        # a step
        diff = np.abs(read_png(b).astype(np.int64) - got)
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size
        assert got.shape == (180, 190, 3)
    assert "bytes" in capsys.readouterr().out


def test_cli_without_gpu_or_device_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root, img, ckpts, _ = files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["compress", img, str(root / "x.epic"), "--checkpoint",
                  ckpts["cnn"]])


@pytest.mark.parametrize("name", ["pic", "cnn"])
def test_demo_tiny(files, tmp_path, name, capsys):
    _, img, _, _ = files
    res = demo.main(["--tiny", "--model", name, "--path_image", img,
                     "--q_levs", *Q_LEVS, "--save_path", str(tmp_path),
                     "--save_recon", "--device", "cpu"])
    out = capsys.readouterr().out
    if name == "cnn":
        assert len(res) == 1 and out.startswith("wacnn: bpp=")
        assert res[0]["bpp"] > 0 and np.isfinite(res[0]["psnr"])
        return
    assert [r["q_ind"] for r in res] == list(range(len(Q_LEVS) + 1))
    bpp = [r["bpp"] for r in res]
    assert bpp == sorted(bpp) and all(np.isfinite(r["psnr"]) for r in res)
    assert (tmp_path / "bits.epic").exists()
    for r in res:
        recon = read_png(str(tmp_path / f"recon_level{r['q_ind']:02d}.png"))
        assert recon.shape == (180, 190, 3)


# ---- rate-distortion evaluation ----

@pytest.fixture(scope="module")
def rem_pair(files):
    _, _, ckpts, jcodecs = files
    return (jcodecs[ckpts["rem"]],
            PICCodec(load_checkpoint(ckpts["rem"])[0], device="cpu"))


def test_rd_sweep_matches_jax(files, rem_pair):
    jcodec, codec = rem_pair
    img = load_image(files[1])
    q = [float(v) for v in Q_LEVS]
    cl = list(codec.model.check_levels)
    want = j_rd_sweep(jcodec, [img], q, check_levels=cl)
    got = rd_sweep(codec, [img], q, check_levels=cl)
    assert got["q_list"] == want["q_list"] and len(got["bpp"]) == 5
    assert got["bpp"] == want["bpp"]
    assert got["bpp"] == sorted(got["bpp"])
    for k in ("psnr", "ms_ssim_db"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert all(v > 0 for v in got["ms_ssim_db"])


def test_compress_with_ac_matches_jax(files, rem_pair):
    jcodec, codec = rem_pair
    img = load_image(files[1])
    cl = list(codec.model.check_levels)
    prs = (0, 0.5, 10)
    want = j_compress_with_ac(jcodec, [img], prs, check_levels=cl)
    got = compress_with_ac(codec, [img], prs, check_levels=cl)
    assert got["bpp"] == want["bpp"] and got["pr_list"] == list(prs)
    for k in ("psnr", "ms_ssim_db"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert json.dumps(got)
