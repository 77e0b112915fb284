"""The port's WACNN (``get_model("cnn")``) against the JAX package's.

- The tiny WACNN (the tiny sizes with division (m, m): single branches, no
  progressive stage), weights drawn with numpy into the JAX tree and
  carried across: the forward's x_hat and likelihoods within 1e-5 in
  float32; in bfloat16 each within twice the JAX package's own
  bf16-versus-float32 difference, as test_torch_pic.py holds bf16 (z's
  likelihoods, which that difference leaves equal, within 1e-5). The JAX
  forward is compiled without XLA's excess precision, so that its bf16
  layers round as their dtype says.
- The trainer's first_train loss (``training=False``) within 1e-5
  relative of the JAX criterion on the JAX model's multi-quality forward.
- ``compress(x, 0, buffered=True)`` at batch 2: one y stream and one z
  stream per image, byte-equal to the JAX package's; each package decodes
  the other's streams to what it decodes from its own, bitwise.
- The trainable masks of a single-branch tree equal the JAX package's
  (``multiple_decoder`` / ``multiple_encoder`` False).
- The trained ``artifacts/ckpt_r5_cnn`` loaded into both packages in
  float32: every array consumed, and a 64x64 crop's likelihoods and x_hat
  within 1e-3 (the tolerance of test_torch_flagship.py).
- ``train_device.run(--model cnn, --device cpu)``, 2 first_train steps:
  its ``last.npz`` loads in the JAX package's ``load_checkpoint`` to the
  trained weights; any other stage is refused.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.models import get_model as j_get_model
from epic_tpu.training import load_checkpoint as j_load_checkpoint
from epic_tpu.training import make_stage as j_make_stage
from epic_tpu.training.losses import CRITERIA as J_CRITERIA
from epic_tpu.training.stages import trainable_mask as j_trainable_mask
from epic_tpu_torch import (PICCodec, from_jax_params, get_model,
                            load_checkpoint, progressive_encode)
from epic_tpu_torch.cli import train_device as td
from epic_tpu_torch.convert import _flatten, to_jax_params
from epic_tpu_torch.models import WACNN
from epic_tpu_torch.training.stages import STAGES, make_stage, trainable_mask
from epic_tpu_torch.training.step import make_train_step
from epic_tpu_torch.utils.synthetic import synth_images
from test_torch_flagship import F32, _crop
from test_torch_layers import random_params
from test_torch_pic import TINY, _image
from test_torch_train_step import FAST_COMPILE, mask_names
from test_torch_train_step import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "ckpt_r5_cnn")
TINY_CNN = dict(TINY, division=(TINY["m"], TINY["m"]))


@pytest.fixture(scope="module")
def tiny():
    jmodel = j_get_model("cnn", **TINY_CNN)
    x = _image()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.asarray(x), method="init_all"))["params"]
    params = random_params(dict(shapes), seed=3)
    model = get_model("cnn", **TINY_CNN)
    model.load_state_dict(from_jax_params(params, model))
    return jmodel, params, model, x


def _forward(jmodel, params, model, x):
    """(port, JAX) x_hat and likelihoods of the deterministic forward. XLA
    runs without excess precision: a bf16 layer's output is rounded to bf16
    as the layer's dtype says (by default XLA on the CPU keeps some of them
    in float32), as the port rounds it."""
    run = jax.jit(lambda p, xj: jmodel.apply({"params": p}, xj, False,
                                             method=jmodel.forward))
    args = (params, jnp.asarray(x))
    jout = run.lower(*args).compile(compiler_options=dict(
        FAST_COMPILE, xla_allow_excess_precision=False))(*args)
    with torch.no_grad():
        out = model(torch.from_numpy(x), training=False)
    pairs = {"x_hat": (out["x_hat"], jout["x_hat"])}
    for k in ("y", "z"):
        pairs[k] = (out["likelihoods"][k], jout["likelihoods"][k])
    return {k: (a.float().numpy(), np.asarray(b, np.float32))
            for k, (a, b) in pairs.items()}


def test_tiny_forward_matches_jax(tiny, record_property):
    jmodel, params, model, x = tiny
    assert isinstance(model, WACNN) and model.division == (32, 32)
    assert not model.progressive and not hasattr(model, "cc_mean_prog")
    assert {k.split(".")[0] for k in model.state_dict()} == set(params)
    f32 = _forward(jmodel, params, model, x)
    assert f32["x_hat"][0].shape == x.shape
    for k, (got, want) in f32.items():
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=k)
    cfg = dict(TINY_CNN, compute_dtype="bfloat16")
    model16 = get_model("cnn", **cfg)
    model16.load_state_dict(model.state_dict())
    b16 = _forward(j_get_model("cnn", **cfg), params, model16, x)
    for k, (got, want) in b16.items():
        diff = np.abs(got - want).max()
        own = np.abs(want - f32[k][1]).max()
        record_property(f"bf16 {k} max abs diff (reference's own)",
                        f"{diff} ({own})")
        # z's likelihoods leave h_a equal in the reference's bf16 and
        # float32 runs: there the float32 tolerance holds
        assert diff <= max(2 * own, 1e-5), \
            f"{k}: {diff} vs the reference's own {own}"


def test_first_train_loss_matches_jax(tiny):
    """The trainer's first_train loss of the tiny WACNN (training=False)
    against the JAX criterion on the JAX model's ``__call__``, as the JAX
    train step computes it: x_hat keeps its level axis, so the hyperprior
    rate is weighted by 1, not by the batch."""
    jmodel, params, model, x = tiny
    plan = j_make_stage("first_train")
    lm = jnp.asarray(plan.lmbda_list, jnp.float32)
    run = jax.jit(lambda p, xj: J_CRITERIA["first_train"](jmodel.apply(
        {"params": p}, xj, list(plan.list_quality), False), xj, lm))
    args = (params, jnp.asarray(x))
    want = run.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    with torch.no_grad():
        got = make_train_step(model, make_stage("first_train"),
                              training=False).loss(torch.from_numpy(x))
    for k in ("loss", "bpp_loss", "bpp_hype", "bpp_base"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_buffered_streams_match_jax(tiny):
    jmodel, params, model, x = tiny
    jcodec = JPICCodec(jmodel, {"params": params})
    codec = PICCodec(model, device="cpu")
    jout = jcodec.compress(x, 0, buffered=True)
    out = codec.compress(x, 0, return_latents=True, buffered=True)
    assert out["buffered"] and jout["buffered"]
    y_strings, z_strings = out["strings"]
    assert len(y_strings) == 1 and len(y_strings[0]) == len(z_strings) == 2
    assert out["strings"] == jout["strings"]
    assert tuple(out["shape"]) == tuple(jout["shape"])
    mine = codec.decompress(out)
    theirs = codec.decompress(jout)
    assert torch.equal(mine["y_hat"], out["y_hat_base"])
    for k in ("x_hat", "y_hat"):
        assert torch.equal(mine[k], theirs[k]), k
    j_mine, j_theirs = jcodec.decompress(jout), jcodec.decompress(out)
    np.testing.assert_array_equal(np.asarray(j_mine["x_hat"]),
                                  np.asarray(j_theirs["x_hat"]))
    np.testing.assert_allclose(mine["x_hat"].numpy(),
                               np.asarray(j_mine["x_hat"]), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="no progressive stage"):
        progressive_encode(codec, x)


def test_single_branch_masks_match_jax(tiny):
    _, params, model, _ = tiny
    names = [n for n, _ in model.named_parameters()]
    for stage in STAGES:
        want = mask_names(j_trainable_mask(params, stage, False, False,
                                           False), params)
        got = trainable_mask(names, stage, False, False, False)
        assert got == want, stage
    trains = {n.split(".")[0] for n, t in trainable_mask(
        names, "refine_gs_ga", False, False, False).items() if t}
    assert trains == {"g_a", "g_s"}


@pytest.fixture(scope="module")
def trained():
    model, config, step = load_checkpoint(CKPT, config_overrides=F32)
    jmodel, jparams, jconfig, jstep = j_load_checkpoint(
        CKPT, config_overrides=F32)
    return model, config, step, jmodel, jparams, jstep


def test_trained_checkpoint_matches_jax(trained):
    model, config, step, jmodel, jparams, jstep = trained
    assert isinstance(model, WACNN) and config["model"] == "cnn"
    assert step == jstep == 15000
    with np.load(os.path.join(CKPT, "last.npz")) as z:
        n_arrays = len(z.files)
    assert n_arrays == len(list(_flatten(jparams))) == len(
        model.state_dict())
    back = dict(_flatten(to_jax_params(model)))
    for path, a in _flatten(jparams):
        np.testing.assert_array_equal(back[path], np.asarray(a),
                                      err_msg="/".join(path))
    x = _crop()
    out = _forward(jmodel, jparams, model, x)
    for k, (got, want) in out.items():
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0, err_msg=k)


def test_train_device_cnn_checkpoint_loads_in_jax(tmp_path):
    imgs = [u8[:128, :192] for u8 in synth_images(2,
                                                   np.random.default_rng(0))]

    def args(steps):
        return td.parse_args([
            "--save_path", str(tmp_path), "--model", "cnn", "--N", "32",
            "--M", "32", "--dim_chunk", "8", "--param_net_widths", "24",
            "16", "--compute_dtype", "float32", "--batch_size", "2",
            "--patch_size", "64", "--steps", steps, "--log_every", "1",
            "--val_every", "2", "--device", "cpu"])

    with pytest.raises(SystemExit, match="first_train"):
        td.run(args("first_train=2,refine_gs=2"), imgs, [True, False])
    res = td.run(args("first_train=2"), imgs, [True, False])
    r = res["stages"]["first_train"]
    assert r["steps"] == 2 and np.isfinite(r["metrics"]["loss"])
    assert r["val"]["pr_list"] == [0.0] and np.isfinite(r["val"]["loss"])
    assert isinstance(res["model"], WACNN)
    jmodel, jparams, jconfig, jstep = j_load_checkpoint(
        str(tmp_path / "first_train"))
    assert jconfig["model"] == "cnn" and jstep == 2
    assert not jmodel.multiple_encoder and jmodel.division == (32, 32)
    trained = dict(_flatten(to_jax_params(res["model"])))
    flat = list(_flatten(jparams))
    assert len(flat) == len(trained)
    for path, a in flat:
        np.testing.assert_array_equal(np.asarray(a), trained[path],
                                      err_msg="/".join(path))
