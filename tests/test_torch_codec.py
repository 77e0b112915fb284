"""The port's random-access codec (``PICCodec.compress`` / ``decompress`` at
one quality), its container and its quality metrics against the JAX
package, on tiny configurations with the same weights, float32 on the CPU.

Streams and containers must be byte-equal, and each package must decode
the other's streams into exactly what it decodes from its own. Latents and
reconstructions are held to 1e-5 absolute of the JAX package's (float32
through ~15 conv layers in another summation order; the largest
difference seen is 3.3e-7). The port's own encoder and decoder agree
bitwise. MS-SSIM is held to the JAX package's within 1e-5 absolute
(float32 filtering in another summation order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import bench
from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import dump_bitstreams as j_dump
from epic_tpu.codec import load_bitstreams as j_load
from epic_tpu.codec.progressive import (progressive_encode_finish,
                                       progressive_encode_start)
from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
from epic_tpu.utils import metrics as jmetrics
from epic_tpu_torch import (PICCodec, VarianceMaskingPIC, dump_bitstreams,
                            from_jax_params, load_bitstreams,
                            progressive_encode)
from epic_tpu_torch.utils import metrics
from epic_tpu_torch.utils.synthetic import synth_images, to_f32
from test_torch_layers import random_params
from test_torch_pic import TINY, _image, _spread_scales
from test_torch_rem import TINY_REM, _pair

QUALITIES = [0.0, 0.5, 10.0]
CKPT_KEYS = ("strings", "shape", "quality", "buffered", "io_chain")


@pytest.fixture(scope="module")
def pic():
    """JAX and port codecs of the tiny ``pic`` model on weights whose
    scales reach most of the 64 CDF tables, and a batch of 2 images."""
    jmodel = JPIC(**TINY)
    x = _image()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.asarray(x),
        method="init_all"))["params"]
    params = _spread_scales(random_params(dict(shapes), seed=4))
    model = VarianceMaskingPIC(**TINY)
    model.load_state_dict(from_jax_params(params, model))
    return JPICCodec(jmodel, {"params": params}), PICCodec(
        model, device="cpu"), x


def _y_out(out, quality):
    return out["y_hat"] if quality > 0 else out["y_hat_base"]


def _strings_equal(a, b):
    ya, za = a["strings"]
    yb, zb = b["strings"]
    assert za == zb
    assert len(ya) == len(yb)
    for i, (sa, sb) in enumerate(zip(ya, yb)):
        assert sa == sb, f"slice {i}"


@pytest.mark.parametrize("quality", QUALITIES)
def test_compress_matches_jax(pic, quality):
    """Per-slice strings byte-equal to the JAX package's; the port's
    decompress returns its compress's latent bitwise; latents and x_hat
    within 1e-5 of the JAX package's."""
    jcodec, codec, x = pic
    jout = jcodec.compress(x, quality, return_latents=True)
    out = codec.compress(x, quality, return_latents=True)
    _strings_equal(out, jout)
    assert tuple(out["shape"]) == tuple(jout["shape"])
    n_slices = codec.model.ns0 + (codec.model.ns1 - codec.model.ns0
                                  if quality > 0 else 0)
    assert len(out["strings"][0]) == n_slices
    dec = codec.decompress(out)
    assert torch.equal(dec["y_hat"], _y_out(out, quality))
    jdec = jcodec.decompress(jout)
    for got, want in ((dec["y_hat"], jdec["y_hat"]),
                      (dec["x_hat"], jdec["x_hat"]),
                      (_y_out(out, quality), _y_out(jout, quality))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("quality", QUALITIES)
def test_each_package_decodes_the_others_compress(pic, quality):
    jcodec, codec, x = pic
    jout = jcodec.compress(x, quality)
    out = codec.compress(x, quality)
    port_of_jax = codec.decompress(dict(jout))
    port_own = codec.decompress(out)
    for k in ("x_hat", "y_hat"):
        assert torch.equal(port_of_jax[k], port_own[k])
    jax_of_port = jcodec.decompress({k: out[k] for k in CKPT_KEYS})
    jax_own = jcodec.decompress(jout)
    for k in ("x_hat", "y_hat"):
        np.testing.assert_array_equal(np.asarray(jax_of_port[k]),
                                      np.asarray(jax_own[k]))


@pytest.fixture(scope="module")
def rem():
    jcodec, codec, _ = _pair(TINY_REM)
    x = _image(b=1)
    st = {}
    bs, _ = progressive_encode(codec, x, rems=True, state=st)
    return jcodec, codec, x, bs, st


def test_rem_receiver_chain_equals_encoder(rem):
    """Each check level's stream, decoded with the previous level's
    decoded latent, gives the encoder's checkpoint latent bitwise (its
    auto-extracted ones and extract_checkpoint), and the JAX package's
    chain within 1e-5; the streams are byte-equal to the JAX package's."""
    jcodec, codec, x, _, st = rem
    prev = jprev = None
    for j, cl in enumerate(codec.model.check_levels):
        out = codec.compress(x, cl, return_latents=True, checkpoint_rep=prev)
        jout = jcodec.compress(x, cl, return_latents=True,
                               checkpoint_rep=jprev)
        _strings_equal(out, jout)
        assert torch.equal(out["y_hat"], codec.extract_checkpoint(x, cl,
                                                                  prev))
        dec = codec.decompress({k: out[k] for k in CKPT_KEYS},
                               checkpoint_rep=prev)
        jdec = jcodec.decompress(jout, checkpoint_rep=jprev)
        prev, jprev = dec["y_hat"], jdec["y_hat"]
        assert torch.equal(prev, st["auto_ckpts"][j])
        assert torch.equal(prev, out["y_hat"])
        np.testing.assert_allclose(prev.numpy(), np.asarray(jprev),
                                   atol=1e-5, rtol=0)


def test_rem_compress_above_the_check_levels(rem):
    """Quality 10 conditioned on the last checkpoint: decompress gives
    compress's latent bitwise; the strings equal the JAX package's."""
    jcodec, codec, x, _, st = rem
    ck = st["auto_ckpts"][-1]
    out = codec.compress(x, 10.0, return_latents=True, checkpoint_rep=ck)
    jout = jcodec.compress(x, 10.0, return_latents=True,
                           checkpoint_rep=ck.numpy())
    _strings_equal(out, jout)
    dec = codec.decompress(out, checkpoint_rep=ck)
    assert torch.equal(dec["y_hat"], out["y_hat"])


def _with_ckpt_streams(codec, bs, x):
    """The stream plus its check levels' compress outputs (by ``codec``, of
    either package) and metadata, as the JAX package's file codec stores
    them."""
    streams, prev = [], None
    for cl in codec.model.check_levels:
        out = codec.compress(x, cl, return_latents=True, checkpoint_rep=prev)
        prev = out["y_hat"]
        streams.append({k: out[k] for k in CKPT_KEYS})
    return dict(bs, ckpt_streams=streams, meta={"rems": True})


def test_container_bytes_equal_across_packages(rem):
    jcodec, codec, x, bs, _ = rem
    jst = progressive_encode_start(jcodec, x, rems=True)
    jbs, _ = progressive_encode_finish(jcodec, jst)
    full = _with_ckpt_streams(codec, bs, x)
    jfull = _with_ckpt_streams(jcodec, jbs, x)
    blob = dump_bitstreams(full)
    assert blob[:8] == b"EPICTPU1"
    assert blob == j_dump(jfull)
    for loaded in (load_bitstreams(blob), j_load(blob)):
        assert dump_bitstreams(loaded) == blob
        assert j_dump(loaded) == blob
        assert loaded["y"] == bs["y"] and loaded["z"] == bs["z"]
        np.testing.assert_array_equal(loaded["prefix"], bs["prefix"])


def test_receiver_decodes_a_loaded_container(rem):
    """From the container alone: the check-level streams rebuild the
    checkpoint latents, and decode_all equals the one with the encoder's."""
    from epic_tpu_torch import progressive_decode_all

    _, codec, x, bs, st = rem
    back = load_bitstreams(dump_bitstreams(_with_ckpt_streams(codec, bs, x)))
    prev, ckpts = None, []
    for s in back["ckpt_streams"]:
        prev = codec.decompress(s, checkpoint_rep=prev)["y_hat"]
        ckpts.append(prev)
    for a, b in zip(ckpts, st["auto_ckpts"]):
        assert torch.equal(a, b)
    got = progressive_decode_all(codec, back, True, ckpts)["x_hat"]
    want = progressive_decode_all(codec, bs, True, st["auto_ckpts"])["x_hat"]
    assert torch.equal(got, want)


def _msssim_pair(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 192, 192, 3), dtype=np.float32)
    noise = rng.normal(0, 0.1, x.shape).astype(np.float32)
    return x, np.clip(x + noise, 0, 1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msssim_matches_jax(dtype):
    """x_hat in float32 or bf16 (widened to float32 inside, as the JAX
    package does); MS-SSIM within 1e-5 of ``_ms_ssim_jit``."""
    x, x_hat = _msssim_pair()
    jx_hat = jnp.asarray(x_hat).astype(dtype)
    want = float(jmetrics._ms_ssim_jit(jx_hat, jnp.asarray(x)))
    t_hat = torch.from_numpy(x_hat).to(getattr(torch, dtype))
    got = float(metrics.ms_ssim(t_hat, torch.from_numpy(x)))
    assert abs(got - want) <= 1e-5
    assert metrics.compute_msssim(t_hat, x) == got
    assert metrics.msssim_db(got) == pytest.approx(jmetrics.msssim_db(want),
                                                   abs=1e-3)


def test_per_level_metrics_match_a_loop():
    x, x_hat = _msssim_pair(1)
    rng = np.random.default_rng(2)
    levels = np.stack([np.clip(x_hat + rng.normal(0, s, x.shape), 0, 1)
                       for s in (0.0, 0.05, 0.2)]).astype(np.float32)
    t_lv, t_x = torch.from_numpy(levels), torch.from_numpy(x)
    psnr = metrics.per_level_psnr(t_lv, t_x).numpy()
    msssim = metrics.per_level_msssim(t_lv, t_x)
    for lvl in range(len(levels)):
        mse = np.mean((levels[lvl].astype(np.float64) - x) ** 2)
        assert psnr[lvl] == pytest.approx(-10 * np.log10(mse), abs=1e-4)
        assert float(msssim[lvl]) == float(metrics.ms_ssim(t_lv[lvl], t_x))
    # as bench.py computes them in the JAX package
    np.testing.assert_allclose(psnr, [
        jmetrics.compute_psnr(lv, x) for lv in levels], atol=1e-4)
    meter = metrics.AverageMeter()
    jmeter = jmetrics.AverageMeter()
    for v in psnr:
        meter.update(v, 2)
        jmeter.update(v, 2)
    assert meter.avg == pytest.approx(jmeter.avg)


def test_synth_images_are_bench_images():
    got = synth_images(3, np.random.default_rng(0))
    want = bench.synth_images(3, np.random.default_rng(0))
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (512, 768, 3)
        np.testing.assert_array_equal(a, b)
    u8 = np.stack(got[:1])
    np.testing.assert_array_equal(to_f32(u8, "cpu").numpy(),
                                  u8.astype(np.float32) / 255.0)
