"""The committed flagship checkpoint (``artifacts/ckpt_r5_flagship``, the
trained ``rem`` model) loaded into both packages and run on one seeded
64x64 crop of the synthetic image, REMs on.

Each package loads the checkpoint once per module. In float32
(``config_overrides={"compute_dtype": "float32"}``): checkpoint latents and
entropy parameters within 1e-3, shell ids and progressive symbols equal,
every level's x_hat within 1e-3 of the JAX decode. In the checkpoint's own
bf16 the two frameworks round in other places, so each difference (entropy
parameters, shell ids, symbols, x_hat) is held to twice the reference's own
bf16-versus-float32 difference on the same weights and crop.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import progressive_decode as j_decode
from epic_tpu.codec.progressive import (progressive_encode_finish,
                                       progressive_encode_start)
from epic_tpu.models import get_model as j_get_model
from epic_tpu.models import VarianceMaskingPIC as JPIC
from epic_tpu.training.checkpoint import load_checkpoint as j_load
from epic_tpu_torch import (PICCodec, VarianceMaskingPIC,
                            VarianceMaskingPICREM, get_model,
                            load_checkpoint, progressive_encode)
from epic_tpu_torch.convert import _flatten, to_jax_params
from epic_tpu_torch.tools.workload import decode_levels
from epic_tpu_torch.utils.synthetic import synthetic_image
from test_torch_layers import TINY, random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "ckpt_r5_flagship")
F32 = {"compute_dtype": "float32"}


def _crop(size=64, seed=0):
    img = synthetic_image()
    rng = np.random.default_rng(seed)
    top = int(rng.integers(0, img.shape[1] - size + 1))
    left = int(rng.integers(0, img.shape[2] - size + 1))
    return np.ascontiguousarray(img[:, top:top + size, left:left + size])


@pytest.fixture(scope="module")
def flagship():
    model16, config, step = load_checkpoint(CKPT)
    jmodel32, jparams, jconfig, jstep = j_load(CKPT, config_overrides=F32)
    cfg32 = {k: v for k, v in config.items() if k != "model"}
    cfg32.update(F32)
    model32 = get_model(config["model"], **cfg32)
    model32.load_state_dict(model16.state_dict())
    cfg16 = {k: tuple(v) if isinstance(v, list) else v
             for k, v in jconfig.items() if k != "model"}
    cfg16["compute_dtype"] = config["compute_dtype"]
    jmodel16 = j_get_model(jconfig["model"], **cfg16)
    return dict(config=config, step=step, jstep=jstep, jparams=jparams,
                model16=model16, model32=model32,
                j32=JPICCodec(jmodel32, {"params": jparams}),
                j16=JPICCodec(jmodel16, {"params": jparams}),
                p32=PICCodec(model32, device="cpu"),
                p16=PICCodec(model16, device="cpu"), x=_crop())


def _back(path, t: torch.Tensor) -> np.ndarray:
    """The port's tensor of a flax leaf in the flax layout again."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "kernel" and t.ndim == 4:
        t = (torch.flip(t.permute(2, 3, 0, 1), (0, 1))
             if parent.startswith("ConvTranspose") else t.permute(2, 3, 1, 0))
    elif name == "kernel" and t.ndim == 2:
        t = t.t()
    elif t.ndim == 5:  # stacked heads and REM banks
        t = t.permute(0, 3, 4, 2, 1)
    return t.numpy()


def test_load_consumes_all_arrays_and_converts_back(flagship):
    model, jparams = flagship["model16"], flagship["jparams"]
    assert isinstance(model, VarianceMaskingPICREM)
    assert flagship["config"]["model"] == "rem"
    assert flagship["step"] == flagship["jstep"] == 8000
    with np.load(os.path.join(CKPT, "last.npz")) as z:
        n_arrays = len(z.files)
    sd = model.state_dict()
    flat = list(_flatten(jparams))
    assert n_arrays == len(flat) == len(sd) == 609
    assert sum(k.startswith("post_latent_") for k in sd) == 84
    for path, a in flat:
        key = ".".join(path[:-1]) + "." + (
            "weight" if path[-1] == "kernel" else path[-1])
        np.testing.assert_array_equal(_back(path, sd[key]), np.asarray(a),
                                      err_msg="/".join(path))


def _write_ckpt(directory, config, params):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"config": config, "step": 3}, f)
    np.savez(os.path.join(directory, "last.npz"),
             **{"/".join(p): np.asarray(a) for p, a in _flatten(params)})


def test_legacy_layout_and_missing_banks_raise(tmp_path):
    """``artifacts/ckpt_r2`` (a ``rem`` model in the per-slice layout)
    loads: every array consumed, and the port's stacked weights equal the
    JAX package's ``stack_legacy_param_nets`` output leaf for leaf. A
    ``rem`` config without REM banks loads as ``pic`` by default; with
    ``disable_rems_if_missing=False`` it loads as the JAX package's loader
    lets its trainer build it (C-8): the ``rem`` model, every checkpoint
    array as written and the banks of a fresh ``init_weights(0)``.
    ``which="best"`` reads ``best.npz``."""
    legacy = os.path.join(ROOT, "artifacts", "ckpt_r2")
    model, config, step = load_checkpoint(legacy)
    _, jparams, jconfig, jstep = j_load(legacy)
    assert isinstance(model, VarianceMaskingPICREM)
    assert config["model"] == jconfig["model"] == "rem"
    assert step == jstep == 4000
    flat = list(_flatten(jparams))
    assert len(flat) == len(model.state_dict())
    back = dict(_flatten(to_jax_params(model)))
    for path, a in flat:
        np.testing.assert_array_equal(back[path], np.asarray(a),
                                      err_msg="/".join(path))

    import jax

    shapes = jax.eval_shape(lambda: JPIC(**TINY).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        method="init_all"))["params"]
    params = random_params(dict(shapes), seed=1)
    rem_cfg = dict(TINY, model="rem", division=list(TINY["division"]),
                   param_net_widths=list(TINY["param_net_widths"]),
                   check_levels=[0.25, 0.75])
    _write_ckpt(tmp_path / "no_banks", rem_cfg, params)
    model, config, step = load_checkpoint(str(tmp_path / "no_banks"),
                                          disable_rems_if_missing=False)
    assert type(model) is VarianceMaskingPICREM and config["model"] == "rem"
    assert config["check_levels"] == [0.25, 0.75] and step == 3
    back = dict(_flatten(to_jax_params(model)))
    flat = list(_flatten(params))
    for path, a in flat:
        np.testing.assert_array_equal(back[path], a, err_msg="/".join(path))
    fresh = get_model("rem", **dict(TINY, check_levels=(0.25, 0.75))) \
        .init_weights(0).state_dict()
    got = model.state_dict()
    banks = [k for k in got if k.startswith("post_latent_")]
    assert len(banks) == len(got) - len(flat) > 0
    assert all(torch.equal(got[k], fresh[k]) for k in banks)
    model, config, step = load_checkpoint(str(tmp_path / "no_banks"))
    assert type(model) is VarianceMaskingPIC and config["model"] == "pic"
    assert "check_levels" not in config and step == 3
    best = dict(params, h_a=dict(params["h_a"]))
    best["h_a"]["Conv_0"] = dict(params["h_a"]["Conv_0"],
                                 bias=params["h_a"]["Conv_0"]["bias"] + 1)
    np.savez(tmp_path / "no_banks" / "best.npz",
             **{"/".join(p): np.asarray(a) for p, a in _flatten(best)})
    got = load_checkpoint(str(tmp_path / "no_banks"), "best")[0]
    np.testing.assert_array_equal(got.state_dict()["h_a.Conv_0.bias"],
                                  best["h_a"]["Conv_0"]["bias"])
    assert not torch.equal(got.state_dict()["h_a.Conv_0.bias"],
                           model.state_dict()["h_a.Conv_0.bias"])


def _encode(flagship, which):
    jcodec, codec, x = flagship["j" + which], flagship["p" + which], \
        flagship["x"]
    jst = progressive_encode_start(jcodec, x, rems=True)
    jbs, _ = progressive_encode_finish(jcodec, jst)
    st = {}
    bs, _ = progressive_encode(codec, x, rems=True, state=st)
    return jst, jbs, st, bs


def _x_hats(flagship, which, jst, jbs, st, bs):
    """Every level's x_hat from the JAX decode of the JAX stream and from
    the port's decode of its own stream, each with its encoder's
    checkpoint latents."""
    jcache, jx, px = {}, [], []
    for lvl, out in decode_levels(flagship["p" + which], bs, None, True,
                                  st["auto_ckpts"]):
        px.append(out["x_hat"].float().numpy())
        jx.append(np.asarray(j_decode(flagship["j" + which], jbs, lvl,
                                      jcache, rems=True,
                                      y_checkpoints=jst["auto_ckpts"])
                             ["x_hat"], np.float32))
    return np.stack(jx), np.stack(px)


@pytest.fixture(scope="module")
def runs(flagship):
    out = {}
    for which in ("32", "16"):
        jst, jbs, st, bs = _encode(flagship, which)
        out[which] = dict(jst=jst, st=st,
                          x=_x_hats(flagship, which, jst, jbs, st, bs))
    return out


def _f32(a):
    return np.asarray(a, np.float32)


def test_float32_matches_jax(runs):
    jst, st = runs["32"]["jst"], runs["32"]["st"]
    for j, (got, want) in enumerate(zip(st["auto_ckpts"], jst["auto_ckpts"])):
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-3,
                                   rtol=0, err_msg=f"checkpoint {j}")
    for k in ("mu_s", "scale_s"):
        np.testing.assert_allclose(st[k].numpy(), _f32(jst[k]), atol=1e-3,
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(st["sid"].numpy(), np.asarray(jst["sid"]))
    np.testing.assert_array_equal(st["psym"].numpy(), np.asarray(jst["p32"]))
    jx, px = runs["32"]["x"]
    assert px.shape == (16,) + (1, 64, 64, 3)
    np.testing.assert_allclose(px, jx, atol=1e-3, rtol=0)


def test_bf16_matches_jax_within_its_own_bf16_error(runs, record_property):
    """The checkpoint's own bf16 in both packages: each difference from the
    reference held to twice the reference's own bf16-vs-float32 difference
    on the same weights and crop."""
    jst, st, jst32 = runs["16"]["jst"], runs["16"]["st"], runs["32"]["jst"]
    for k in ("mu_s", "scale_s"):
        got = np.abs(st[k].float().numpy() - _f32(jst[k])).max()
        own = np.abs(_f32(jst[k]) - _f32(jst32[k])).max()
        record_property(f"{k} max abs diff (reference's own)",
                        f"{got} ({own})")
        assert got <= 2 * own, f"{k}: {got} vs the reference's own {own}"
    counts = {}
    for name, k, jk in (("shell ids", "sid", "sid"),
                        ("progressive symbols", "psym", "p32")):
        counts[name] = (
            np.count_nonzero(st[k].numpy() != np.asarray(jst[jk])),
            np.count_nonzero(np.asarray(jst[jk]) != np.asarray(jst32[jk])))
    report = ", ".join(f"{k}: {a} differ from the reference (its own bf16 "
                       f"vs float32: {b}) of {st['sid'].numel()}"
                       for k, (a, b) in counts.items())
    record_property("flips", report)
    for got, own in counts.values():
        assert got <= 2 * own, report
    jx, px = runs["16"]["x"]
    jx32 = runs["32"]["x"][0]
    got, own = np.abs(px - jx).max(), np.abs(jx - jx32).max()
    record_property("x_hat max abs diff (reference's own)", f"{got} ({own})")
    assert got <= 2 * own, f"x_hat: {got} vs the reference's own {own}"
