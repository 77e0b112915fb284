"""The PyTorch port's progressive codec against the JAX package, on the
tiny ``pic`` configuration with the same weights carried across.

Weights are drawn with numpy into the exact ``init_all`` parameter tree
(shapes from ``jax.eval_shape``). Float32 on the CPU. Tolerances: entropy
parameters within 1e-4 (float32 through ~15 conv layers in another
order), reconstructions within 1e-3 of the JAX decode of the same image.
The port's own encode -> decode must round-trip bitwise at every level,
and a stream written by either package must decode in the other with the
same symbols at every level (``wide``: weights whose scales reach most of
the 64 CDF tables). In bfloat16 the packages round in other places, so
there each difference is held to twice the reference's own difference
between its bfloat16 and float32 results on the same weights.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import progressive_decode as j_decode
from epic_tpu.codec import progressive_encode as j_encode
from epic_tpu.codec.progressive import (progressive_encode_finish,
                                       progressive_encode_start)
from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
from epic_tpu_torch import (PICCodec, VarianceMaskingPIC, from_jax_params,
                            progressive_decode, progressive_encode)
from epic_tpu_torch.codec.progressive import decoded_symbols
from epic_tpu_torch.tools.workload import decode_levels
from test_torch_layers import random_params

TINY = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))


def _image(b=2, h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = 0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[None, :, :, None]
    return np.clip(base + 0.1 * rng.standard_normal((b, h, w, 3)), 0,
                   1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jmodel = JPIC(**TINY)
    x = _image()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.asarray(x),
        method="init_all"))["params"]
    params = random_params(dict(shapes), seed=4)
    model = VarianceMaskingPIC(**TINY)
    model.load_state_dict(from_jax_params(params, model))
    return (JPICCodec(jmodel, {"params": params}),
            PICCodec(model, device="cpu"), params, x)


def test_convert_consumes_every_array(pair):
    _, _, params, _ = pair
    model = VarianceMaskingPIC(**TINY)
    sd = from_jax_params(params, model)
    assert set(sd) == set(model.state_dict())
    extra = dict(params, stray={"kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="left over"):
        from_jax_params(extra, model)
    missing = {k: v for k, v in params.items() if k != "lrp"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(missing, model)
    bf16 = dict(params, h_a=dict(params["h_a"]))
    bf16["h_a"]["Conv_0"] = {
        "kernel": np.asarray(jnp.asarray(params["h_a"]["Conv_0"]["kernel"],
                                         jnp.bfloat16)).view("V2"),
        "bias": params["h_a"]["Conv_0"]["bias"]}
    w = from_jax_params(bf16, model)["h_a.Conv_0.weight"]
    np.testing.assert_allclose(w.numpy(), sd["h_a.Conv_0.weight"].numpy(),
                               rtol=1e-2)


def test_entropy_params_match(pair):
    jcodec, codec, _, x = pair
    st = {}
    progressive_encode(codec, x, state=st)
    jst = progressive_encode_start(jcodec, x)
    v = jcodec.variables
    _, y_base, z_sym = jcodec._p_front()(v, jnp.asarray(x),
                                         jcodec._z_med_dev)
    lm, ls = jcodec._p_zhat_hyper(False)(v, z_sym, jcodec._z_med_dev)
    d0 = TINY["division"][0]
    chain = jcodec._p_base_chain_scan()(v, y_base, lm[..., :d0],
                                        ls[..., :d0])
    pairs = [(torch.stack(st["base_slices"]), chain[0]),
             (torch.stack(st["base_mu"]), chain[1]),
             (torch.stack(st["base_scale"]), chain[2]),
             (st["mu_s"], jst["mu_s"]), (st["scale_s"], jst["scale_s"])]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(st["sid"].numpy(), np.asarray(jst["sid"]))
    np.testing.assert_array_equal(st["psym"].numpy(), np.asarray(jst["p32"]))


def test_roundtrip_bitwise_every_level(pair):
    _, codec, _, x = pair
    st = {}
    bs, bits = progressive_encode(codec, x, state=st)
    assert np.all(np.diff(bs["prefix"], axis=1) >= 0) and min(bits[2]) >= 0
    p_flat = st["psym"].transpose(0, 1).reshape(x.shape[0], -1).numpy()
    sid_flat = st["sid"].transpose(0, 1).reshape(x.shape[0], -1).numpy()
    levels = []
    for lvl, out in decode_levels(codec, bs):
        levels.append(lvl)
        if lvl == 0:
            x_e, y_e = codec.synth_base(st["base_slices"])
        else:
            keep = st["sid"].to(torch.int32) < lvl
            x_e, y_e = codec.prog_reconstruct(st["psym"] * keep, st["mu_s"],
                                              st["msups"], st["base_slices"])
            np.testing.assert_array_equal(
                decoded_symbols(out["cache"]),
                np.where(sid_flat < lvl, p_flat, 0))
        assert torch.equal(out["y_hat"], y_e)
        assert torch.equal(out["x_hat"], x_e)
    assert levels == list(range(len(bs["q_list"]) + 1))


def test_xhat_matches_jax_decode(pair):
    jcodec, codec, _, x = pair
    bs, _ = progressive_encode(codec, x)
    jbs, _ = j_encode(jcodec, x)
    cache, jcache = {}, {}
    for lvl in range(len(bs["q_list"]) + 1):
        got = progressive_decode(codec, bs, lvl, cache)["x_hat"].numpy()
        want = np.asarray(j_decode(jcodec, jbs, lvl, jcache)["x_hat"])
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PICCodec(VarianceMaskingPIC(**TINY))


def _spread_scales(params):
    """params with the last bias of the scale heads spread geometrically
    over the scale table, so the streams use many of the 64 CDF tables,
    among them 41 (base) and 50 (progressive), where torch's float32 erfc
    moves entries by one count against XLA's."""
    out = dict(params)
    for head, (lo, hi) in (("cc_scale", (0.3, 250.0)),
                           ("cc_scale_prog", (0.15, 120.0))):
        out[head] = dict(params[head])
        b = params[head]["Conv_2_bias"]
        out[head]["Conv_2_bias"] = np.geomspace(lo, hi, b.size).reshape(
            b.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def wide(pair):
    """Both packages' codecs on the spread weights, each package's stream
    of the same image, and the encoders' symbols and shell ids."""
    jmodel = pair[0].model
    _, _, params, x = pair
    params = _spread_scales(params)
    model = VarianceMaskingPIC(**TINY)
    model.load_state_dict(from_jax_params(params, model))
    jcodec = JPICCodec(jmodel, {"params": params})
    codec = PICCodec(model, device="cpu")
    jst = progressive_encode_start(jcodec, x)
    jbs, _ = progressive_encode_finish(jcodec, jst)
    st = {}
    bs, _ = progressive_encode(codec, x, state=st)
    base_idx = np.asarray(jst["base_idx"])
    prog_idx = np.asarray(jst["idx_full"])
    assert np.count_nonzero(base_idx == 41) and np.count_nonzero(
        prog_idx == 50), "the streams must use CDF tables 41 and 50"
    return dict(jcodec=jcodec, codec=codec, jbs=jbs, bs=bs, st=st,
                jsym=np.asarray(jst["p32"]), jsid=np.asarray(jst["sid"]))


def _masked(sym, sid, lvl):
    return np.where(sid < lvl, sym, 0)


def test_streams_byte_identical(wide):
    bs, jbs = wide["bs"], wide["jbs"]
    assert bs["shape"] == jbs["shape"] and bs["q_list"] == jbs["q_list"]
    assert bs["z"] == jbs["z"] and bs["y"] == jbs["y"]
    np.testing.assert_array_equal(bs["prefix"], jbs["prefix"])


def test_jax_stream_decodes_in_port(wide):
    """The port decodes the JAX package's stream at every level into the
    JAX encoder's symbols and exactly what the port's own encoder
    reconstructs; x_hat within 1e-3 of the JAX decode (float32 through g_s
    in two libraries)."""
    codec, st, jsym, jsid = (wide["codec"], wide["st"], wide["jsym"],
                             wide["jsid"])
    b = jsym.shape[1]
    jcache = {}
    for lvl, out in decode_levels(codec, wide["jbs"]):
        if lvl == 0:
            x_e, y_e = codec.synth_base(st["base_slices"])
        else:
            want = _masked(jsym, jsid, lvl).transpose(1, 0, 2, 3, 4)
            np.testing.assert_array_equal(decoded_symbols(out["cache"]),
                                          want.reshape(b, -1))
            keep = st["sid"].to(torch.int32) < lvl
            x_e, y_e = codec.prog_reconstruct(st["psym"] * keep, st["mu_s"],
                                              st["msups"], st["base_slices"])
        assert torch.equal(out["y_hat"], y_e), f"level {lvl}"
        assert torch.equal(out["x_hat"], x_e), f"level {lvl}"
        ref = j_decode(wide["jcodec"], wide["jbs"], lvl, jcache)
        np.testing.assert_allclose(out["x_hat"].numpy(),
                                   np.asarray(ref["x_hat"]), atol=1e-3,
                                   rtol=0)


def test_port_stream_decodes_in_jax(wide):
    """The JAX package decodes the port's stream at every level into the
    port encoder's symbols and exactly what it decodes from its own
    stream; x_hat within 1e-3 of the port's (float32 through g_s in two
    libraries)."""
    jcodec, codec, st = wide["jcodec"], wide["codec"], wide["st"]
    psym, sid = st["psym"].numpy(), st["sid"].numpy()
    cache, own = {}, {}
    for lvl in range(len(wide["bs"]["q_list"]) + 1):
        got = j_decode(jcodec, wide["bs"], lvl, cache)
        want = j_decode(jcodec, wide["jbs"], lvl, own)
        if lvl:
            np.testing.assert_array_equal(np.asarray(cache["canvas"]),
                                          _masked(psym, sid, lvl))
        for k in ("y_hat", "x_hat"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"level {lvl} {k}")
        if lvl == 0:
            x_p = codec.synth_base(st["base_slices"])[0]
        else:
            keep = st["sid"].to(torch.int32) < lvl
            x_p = codec.prog_reconstruct(st["psym"] * keep, st["mu_s"],
                                         st["msups"], st["base_slices"])[0]
        np.testing.assert_allclose(np.asarray(got["x_hat"]),
                                   x_p.detach().numpy(), atol=1e-3, rtol=0)


def test_bf16_matches_jax_within_its_own_bf16_error(pair, record_property):
    """Both packages in bfloat16 on the same weights and image. The two
    frameworks round bf16 work in other places (XLA on the CPU keeps some
    intermediates in float32 and rounds others step by step), so the port
    cannot equal the reference bitwise. Each difference between them is
    held to twice the reference's own bf16-vs-float32 difference (each side
    may be that far from float32): entropy parameters, x_hat over all
    levels, and the counts of shell ids, progressive symbols and base
    symbols that flip. The measured differences go to the test's junit
    properties."""
    jcodec32, _, params, x = pair
    cfg = dict(TINY, compute_dtype="bfloat16")
    jcodec = JPICCodec(JPIC(**cfg), {"params": params})
    model = VarianceMaskingPIC(**cfg)
    model.load_state_dict(from_jax_params(params, model))
    codec = PICCodec(model, device="cpu")
    jst = progressive_encode_start(jcodec, x)
    jbs, _ = progressive_encode_finish(jcodec, jst)
    jst32 = progressive_encode_start(jcodec32, x)
    jbs32, _ = progressive_encode_finish(jcodec32, jst32)
    st = {}
    bs, _ = progressive_encode(codec, x, state=st)

    def f32(a):
        return np.asarray(a, np.float32)

    for k in ("mu_s", "scale_s"):
        got = np.abs(st[k].float().numpy() - f32(jst[k])).max()
        own = np.abs(f32(jst[k]) - f32(jst32[k])).max()
        record_property(f"{k} max abs diff (reference's own)",
                        f"{got} ({own})")
        assert got <= 2 * own, f"{k}: {got} vs the reference's own {own}"

    def base_sym(s):
        return jcodec._get_sym(s["base_s8"], s["base_s16"], s["base_s32"],
                               s["base_flag8"], s["base_flag16"])

    port_base = torch.stack(st["base_sym"]).numpy()
    counts = {
        "shell ids": (np.count_nonzero(st["sid"].numpy()
                                       != np.asarray(jst["sid"])),
                      np.count_nonzero(np.asarray(jst["sid"])
                                       != np.asarray(jst32["sid"]))),
        "progressive symbols": (
            np.count_nonzero(st["psym"].numpy() != np.asarray(jst["p32"])),
            np.count_nonzero(np.asarray(jst["p32"])
                             != np.asarray(jst32["p32"]))),
        "base symbols": (np.count_nonzero(port_base != base_sym(jst)),
                         np.count_nonzero(base_sym(jst) != base_sym(jst32))),
    }
    report = ", ".join(f"{k}: {a} differ from the reference (its own bf16 "
                       f"vs float32: {b}) of {st['sid'].numel()}"
                       for k, (a, b) in counts.items())
    record_property("flips", report)
    for got, own in counts.values():
        assert got <= 2 * own, report

    jcache, jcache32 = {}, {}
    got = own = 0.0
    for lvl, out in decode_levels(codec, bs):
        ref = f32(j_decode(jcodec, jbs, lvl, jcache)["x_hat"])
        ref32 = f32(j_decode(jcodec32, jbs32, lvl, jcache32)["x_hat"])
        got = max(got, np.abs(out["x_hat"].float().numpy() - ref).max())
        own = max(own, np.abs(ref - ref32).max())
    record_property("x_hat max abs diff (reference's own)", f"{got} ({own})")
    assert got <= 2 * own, f"x_hat: {got} vs the reference's own {own}"
