"""The port's ``rem`` model (Rate Enhancement Modules) and its codec path
against the JAX package, on a tiny configuration with the same weights.

Weights are drawn with numpy into the exact flax tree (shapes from
``jax.eval_shape``), the stacked REM banks included. Float32 on the CPU.
Tolerances: a REM bank alone within 1e-5 (float32 through ~20 small convs
in another order); checkpoint latents and REM-chained entropy params within
1e-4 (as the ``pic`` parameters in test_torch_pic.py); shell ids and
symbols equal; x_hat within 1e-3 of the JAX decode. The port's own encoder
and decoder, and its auto-extracted and separately extracted checkpoint
latents, must agree bitwise. ``apply_all`` loops over ``apply_slice``
(the route the port takes), so the two must give the same bits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import progressive_decode as j_decode
from epic_tpu.codec.progressive import (progressive_decode_all as
                                        j_decode_all,
                                        progressive_encode_finish,
                                        progressive_encode_start)
from epic_tpu.models import get_model as j_get_model
from epic_tpu.ops.rem import ResidualBlock as JResidualBlock
from epic_tpu.ops.rem import ResidualBlockSmall as JResidualBlockSmall
from epic_tpu.ops.rem import lrr_apply
from epic_tpu_torch import (PICCodec, from_jax_params, get_model,
                            progressive_decode_all, progressive_encode)
from epic_tpu_torch.codec.progressive import decoded_symbols
from epic_tpu_torch.ops import rem as rem_ops
from epic_tpu_torch.tools.workload import decode_levels
from test_torch_layers import random_params
from test_torch_pic import _image

TINY_REM = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
                param_net_widths=(24, 16), check_levels=(0.25, 0.75),
                rem_dimension="middle")


def _pair(config, params=None, seed=5):
    """(JAX codec, port codec, params) of one config on the same weights."""
    jmodel = j_get_model("rem", **config)
    if params is None:
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), method="init_all"))["params"]
        params = random_params(dict(shapes), seed=seed)
    model = get_model("rem", **config)
    model.load_state_dict(from_jax_params(params, model))
    return (JPICCodec(jmodel, {"params": params}),
            PICCodec(model, device="cpu"), params)


@pytest.fixture(scope="module")
def rem():
    jcodec, codec, params = _pair(TINY_REM)
    x = _image()
    jst = progressive_encode_start(jcodec, x, rems=True)
    jbs, _ = progressive_encode_finish(jcodec, jst)
    st = {}
    bs, _ = progressive_encode(codec, x, rems=True, state=st)
    return dict(jcodec=jcodec, codec=codec, params=params, x=x, jst=jst,
                jbs=jbs, st=st, bs=bs)


def test_convert_consumes_every_array_with_banks(rem):
    params = rem["params"]
    model = get_model("rem", **TINY_REM)
    sd = from_jax_params(params, model)
    assert set(sd) == set(model.state_dict())
    assert {k.split(".")[0] for k in sd if k.startswith("post_latent")} == \
        {"post_latent_0", "post_latent_1"}
    k = params["post_latent_1"]["fuse_0"]["Conv_2"]["kernel"]  # [S,1,1,in,out]
    np.testing.assert_array_equal(
        sd["post_latent_1.fuse_0.Conv_2.weight"].numpy(),
        np.transpose(np.asarray(k, np.float32), (0, 4, 3, 1, 2)))
    missing = {k: v for k, v in params.items() if k != "post_latent_1"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(missing, model)


def _bank_inputs(s, b=2, h=4, w=4, c=8, seed=0):
    rng = np.random.default_rng(seed)
    x_base = rng.normal(0, 1, (s, b, h, w, c)).astype(np.float32)
    p_base = rng.normal(0, 1, (s, b, h, w, 2 * c)).astype(np.float32)
    p_prog = rng.normal(0, 1, (s, b, h, w, 2 * c)).astype(np.float32)
    att = (rng.random((s, b, h, w, 2 * c)) < 0.5).astype(np.float32)
    return x_base, p_base, p_prog, att


@pytest.mark.parametrize("bank", [0, 1])
def test_bank_matches_lrr_apply(rem, bank):
    """apply_slice against JAX lrr_apply on slice i's weights, and
    apply_all bitwise equal to apply_slice per slice."""
    model = rem["codec"].model
    stacked = rem["params"][f"post_latent_{bank}"]
    ins = _bank_inputs(model.ns0)
    tins = [torch.from_numpy(a) for a in ins]
    got_all = model.bank(bank).apply_all(*tins)
    for i in range(model.ns0):
        sub = jax.tree.map(lambda a: jnp.asarray(a)[i], stacked)
        want = lrr_apply(sub, *(jnp.asarray(a[i]) for a in ins))
        got = model.bank(bank).apply_slice(i, *(t[i] for t in tins))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        assert torch.equal(got_all[i], got)


@pytest.mark.parametrize("kind", ["ResidualBlock", "ResidualBlockSmall"])
@pytest.mark.parametrize("in_ch", [8, 12])
def test_residual_blocks_match_flax(kind, in_ch):
    """One slice of a stacked block against the flax module (8 -> 8 has no
    projection, 12 -> 8 projects x with a 1x1 conv)."""
    jblock = {"ResidualBlock": JResidualBlock,
              "ResidualBlockSmall": JResidualBlockSmall}[kind](8)
    x = np.random.default_rng(3).normal(0, 1, (2, 4, 4, in_ch)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.key(0),
                                                jnp.asarray(x)))["params"]
    params = random_params(dict(shapes), seed=2)
    # the port's blocks hold S stacked slices: slice 1 gets these weights
    stacked = jax.tree.map(lambda a: np.stack([a * 0.5, a]), params)
    block = getattr(rem_ops, kind)(2, in_ch, 8)
    block.load_state_dict(from_jax_params(stacked, block))
    want = jblock.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = block.apply_slice(1, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("quality", [0.0, 0.01, 0.25, 0.3, 0.75, 1.0, 10.0])
def test_check_quality_brackets_match(rem, quality):
    jmodel, model = rem["jcodec"].model, rem["codec"].model
    assert model.find_check_quality(quality) == \
        jmodel.find_check_quality(quality)
    assert model.rem_bank_index(quality) == jmodel._rem_bank_index(quality)


@pytest.mark.parametrize("quality", [0.1, 0.5, 2.0])
def test_refine_prog_params_all_matches(rem, quality):
    """One quality, every slice: bank 0 at 0.5, bank 1 at 2.0, none at
    0.1 (<= the first check level)."""
    jcodec, model = rem["jcodec"], rem["codec"].model
    rng = np.random.default_rng(7)
    s, shp = model.ns0, (2, 4, 4, 8)
    mus, mus_b = (rng.normal(0, 1, (s,) + shp).astype(np.float32)
                  for _ in range(2))
    scales, scales_b = (rng.uniform(0.1, 3, (s,) + shp).astype(np.float32)
                        for _ in range(2))
    ckpt = rng.normal(0, 1, shp[:3] + (16,)).astype(np.float32)
    want = jcodec.model.apply(jcodec.variables, quality, mus, scales, ckpt,
                              mus_b, scales_b,
                              method=type(jcodec.model)
                              ._refine_prog_params_all)
    got = model.refine_prog_params_all(
        quality, *(torch.from_numpy(a) for a in (mus, scales, ckpt, mus_b,
                                                  scales_b)))
    for g, w, unrefined in zip(got, want, (mus, scales)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0)
        if quality <= TINY_REM["check_levels"][0]:
            np.testing.assert_array_equal(g.numpy(), unrefined)


def test_extract_checkpoint_chain_matches(rem):
    """0.25, then 0.75 with the first as checkpoint_rep, against JAX
    extract_checkpoint_device (1e-4); the base latent at quality 0; the
    port's auto_ckpts equal its own extract_checkpoint bitwise."""
    jcodec, codec, x, st = rem["jcodec"], rem["codec"], rem["x"], rem["st"]
    prev = jprev = None
    for j, q in enumerate(TINY_REM["check_levels"]):
        prev = codec.extract_checkpoint(x, q, prev)
        jprev = jcodec.extract_checkpoint_device(x, q, jprev)
        np.testing.assert_allclose(prev.numpy(), np.asarray(jprev),
                                   atol=1e-4, rtol=0)
        assert torch.equal(st["auto_ckpts"][j], prev)
        np.testing.assert_array_equal(np.asarray(rem["jst"]["auto_ckpts"][j]),
                                      np.asarray(jprev))
    base = codec.extract_checkpoint(x, 0.0)
    assert torch.equal(base, torch.cat(st["base_slices"], dim=-1))
    np.testing.assert_allclose(
        base.numpy(), np.asarray(jcodec.extract_checkpoint_device(x, 0.0)),
        atol=1e-4, rtol=0)


def test_prog_params_at_matches(rem):
    """The one-quality params with a checkpoint (the refined mu / scale,
    the mask and the masked CDF indexes) against JAX _p_prog_params."""
    jcodec, codec, x, st = rem["jcodec"], rem["codec"], rem["x"], rem["st"]
    ck = st["auto_ckpts"][0]
    with torch.no_grad():
        got = codec.prog_params_at(0.75, st["base_slices"], st["lm"],
                                   st["ls"], ck, st["base_mu"],
                                   st["base_scale"])
    jst = rem["jst"]
    mus_b, scales_b = _base_params(jcodec, x, TINY_REM["division"][0])
    want = jcodec._p_prog_params(0.75, True)(
        jcodec.variables, jst["base_slices"], jst["lm"], jst["ls"],
        jnp.asarray(ck.numpy()), mus_b, scales_b)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy().astype(np.int8),
                                  np.asarray(want[3]))


def _base_params(jcodec, x, d0):
    v = jcodec.variables
    _, y_base, z_sym = jcodec._p_front()(v, jnp.asarray(x), jcodec._z_med_dev)
    lm, ls = jcodec._p_zhat_hyper(False)(v, z_sym, jcodec._z_med_dev)
    chain = jcodec._p_base_chain_scan()(v, y_base, lm[..., :d0],
                                        ls[..., :d0])
    return chain[1], chain[2]


def test_rem_chain_params_match(rem):
    """REM-chained mu_s / scale_s against JAX _p_prog_params_rem_chain(2)
    within 1e-4; shell ids and progressive symbols equal."""
    st, jst = rem["st"], rem["jst"]
    for k in ("mu_s", "scale_s"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-4, rtol=0)
    np.testing.assert_array_equal(st["sid"].numpy(), np.asarray(jst["sid"]))
    np.testing.assert_array_equal(st["psym"].numpy(), np.asarray(jst["p32"]))
    plain = rem["codec"].prog_params(st["base_slices"], st["lm"], st["ls"])
    assert not torch.equal(plain[1], st["scale_s"]), "the banks did not run"


@torch.no_grad()
def _encoder_levels(codec, st, lvl):
    if lvl == 0:
        return codec.synth_base(st["base_slices"])
    keep = st["sid"].to(torch.int32) < lvl
    return codec.prog_reconstruct(st["psym"] * keep, st["mu_s"],
                                  st["msups"], st["base_slices"])


def test_roundtrip_bitwise_every_level(rem):
    codec, bs, st = rem["codec"], rem["bs"], rem["st"]
    b = st["psym"].shape[1]
    p_flat = st["psym"].transpose(0, 1).reshape(b, -1).numpy()
    sid_flat = st["sid"].transpose(0, 1).reshape(b, -1).numpy()
    for lvl, out in decode_levels(codec, bs, None, True, st["auto_ckpts"]):
        x_e, y_e = _encoder_levels(codec, st, lvl)
        if lvl:
            np.testing.assert_array_equal(decoded_symbols(out["cache"]),
                                          np.where(sid_flat < lvl, p_flat, 0))
        assert torch.equal(out["y_hat"], y_e), f"level {lvl}"
        assert torch.equal(out["x_hat"], x_e), f"level {lvl}"


def test_jax_stream_decodes_in_port(rem):
    """The port decodes the JAX rems=True stream, given the JAX encoder's
    checkpoint latents, into the JAX encoder's symbols at every level, and
    into what the port's own encoder reconstructs."""
    codec, st, jst = rem["codec"], rem["st"], rem["jst"]
    ckpts = [np.asarray(c) for c in jst["auto_ckpts"]]
    jsym, jsid = np.asarray(jst["p32"]), np.asarray(jst["sid"])
    b = jsym.shape[1]
    for lvl, out in decode_levels(codec, rem["jbs"], None, True, ckpts):
        if lvl:
            want = np.where(jsid < lvl, jsym, 0).transpose(1, 0, 2, 3, 4)
            np.testing.assert_array_equal(decoded_symbols(out["cache"]),
                                          want.reshape(b, -1))
        x_e, _ = _encoder_levels(codec, st, lvl)
        np.testing.assert_allclose(out["x_hat"].numpy(), x_e.numpy(),
                                   atol=1e-5, rtol=0)


def test_port_stream_decodes_in_jax(rem):
    """The JAX package decodes the port's rems=True stream, given the
    port's checkpoint latents, into the port encoder's symbols at every
    level; x_hat within 1e-3 of the port's."""
    jcodec, codec, st = rem["jcodec"], rem["codec"], rem["st"]
    ckpts = [jnp.asarray(c.numpy()) for c in st["auto_ckpts"]]
    psym, sid = st["psym"].numpy(), st["sid"].numpy()
    cache = {}
    for lvl in range(len(rem["bs"]["q_list"]) + 1):
        got = j_decode(jcodec, rem["bs"], lvl, cache, rems=True,
                       y_checkpoints=ckpts)
        if lvl:
            np.testing.assert_array_equal(np.asarray(cache["canvas"]),
                                          np.where(sid < lvl, psym, 0))
        x_p = _encoder_levels(codec, st, lvl)[0]
        np.testing.assert_allclose(np.asarray(got["x_hat"]), x_p.numpy(),
                                   atol=1e-3, rtol=0)


def test_decode_all_matches_per_level_and_jax(rem):
    codec, bs, st = rem["codec"], rem["bs"], rem["st"]
    out = progressive_decode_all(codec, bs, True, st["auto_ckpts"])
    nq = len(bs["q_list"])
    assert tuple(out["x_hat"].shape) == (1 + nq,) + rem["x"].shape
    for lvl, o in decode_levels(codec, bs, None, True, st["auto_ckpts"]):
        np.testing.assert_allclose(out["x_hat"][lvl].numpy(),
                                   o["x_hat"].numpy(), atol=1e-5, rtol=0)
    jckpts = [jnp.asarray(c.numpy()) for c in st["auto_ckpts"]]
    want = j_decode_all(rem["jcodec"], bs, rems=True, y_checkpoints=jckpts)
    np.testing.assert_allclose(out["x_hat"].numpy(),
                               np.asarray(want["x_hat"]), atol=1e-3, rtol=0)


def test_single_check_level_is_the_plain_stream(rem):
    """One check level: the chained refinement's only step is j = 0, a
    no-op, so rems=True writes the rems=False stream (and JAX agrees)."""
    cfg = dict(TINY_REM, check_levels=(0.5,))
    params = {k: v for k, v in rem["params"].items()
              if k != "post_latent_1"}
    jcodec, codec, _ = _pair(cfg, params)
    x = rem["x"]
    st = {}
    bs_rem, _ = progressive_encode(codec, x, rems=True, state=st)
    bs_plain, _ = progressive_encode(codec, x)
    assert len(st["auto_ckpts"]) == 1
    assert bs_rem["y"] == bs_plain["y"] and bs_rem["z"] == bs_plain["z"]
    jbs, _ = progressive_encode_finish(
        jcodec, progressive_encode_start(jcodec, x, rems=True))
    assert jbs["y"] == bs_rem["y"]
