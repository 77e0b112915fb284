"""The non-default PIC options of the port against the JAX package, on the
tiny ``pic`` and ``rem`` configurations with the same weights, float32 on
the CPU:

- ``all_scalable=False``: the interleaved progressive chain, in the
  multi-quality forward at [0, 0.5, 10] (``pic``) and
  ``forward_single_quality`` at 0.5 (``rem``, its REMs refining each slice
  from a checkpoint latent, above the first check level); ``compress``
  strings byte-equal to the JAX package's at 0.5 and 10 (``rem``: its
  check levels chained first, each checkpoint latent within tolerance of
  the JAX package's), each package decoding the other's strings into what
  it decodes from its own (the JAX package's decode of the port's strings
  bitwise its own encoder's latent), and the port's decoder bitwise its
  encoder;
- ``delta_encode=False``, ``total_mu_rep=False`` and ``mask_policy=
  "two-levels"``: one ``pic`` configuration with all three, so that one
  JAX codec serves them (a JAX codec compiles its programs anew for each
  configuration, several seconds each): the multi-quality forward and a
  compress at 0.5, held the same way; and each option alone changes the
  port's forward;
- ``progressive_encode`` refuses an ``all_scalable=False`` model with the
  JAX package's ValueError, an unknown mask policy raises
  NotImplementedError in both packages, "two-levels" masks equal the JAX
  package's, and ``from_jax_params`` / ``to_jax_params`` map such a
  model's tree one to one.

``cli.train --no_all_scalable`` trains in test_torch_train_host.py.
Weights are drawn with numpy into the flax tree from ``jax.eval_shape``.
Tolerances, those of test_torch_pic.py for the tiny model: latents,
entropy parameters and likelihoods within 1e-4 absolute (float32 through
~15 conv layers in another order), reconstructions within 1e-3. Strings
and symbols are equal. The JAX forwards of one configuration are one
program, compiled at XLA's cheapest optimization level.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import progressive_encode as j_progressive_encode
from epic_tpu.models import get_model as j_get_model
from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
from epic_tpu.ops.masking import variance_mask as j_variance_mask
from epic_tpu_torch import (PICCodec, from_jax_params, get_model,
                            progressive_encode)
from epic_tpu_torch.convert import to_jax_params
from epic_tpu_torch.ops.masking import variance_mask
from test_torch_layers import random_params
from test_torch_pic import _image
from test_torch_train_step import FAST_COMPILE, TINY, TINY_REM
from test_torch_train_step import one_torch_thread  # noqa: F401

ATOL, X_ATOL = 1e-4, 1e-3
KEYS = ("strings", "shape", "quality", "buffered", "io_chain")
# (registry name, options) of each configuration under test
CONFIGS = {
    "pic-non_scalable": ("pic", dict(all_scalable=False)),
    "rem-non_scalable": ("rem", dict(all_scalable=False)),
    "pic-options_off": ("pic", dict(delta_encode=False, total_mu_rep=False,
                                    mask_policy="two-levels")),
}
# the qualities of the forwards: multi-quality (pic), single (rem)
MULTI_Q, SINGLE_Q = [0, 0.5, 10], 0.5


@functools.lru_cache(maxsize=None)
def _params(name):
    """Numpy weights in the flax tree of the tiny ``name`` model (its
    shapes do not depend on the options): the ``rem`` tree, and for
    ``pic`` the same tree without the REM banks."""
    if name == "pic":
        return {k: v for k, v in _params("rem").items()
                if not k.startswith("post_latent")}
    jmodel = j_get_model("rem", **TINY_REM)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), method="init_all"))["params"]
    return random_params(dict(shapes), seed=5)


_JCODECS = {}


@functools.lru_cache(maxsize=None)
def _setup(key):
    """(JAX model, JAX codec, port model, port codec, params) of one
    configuration."""
    name, opts = CONFIGS[key]
    config = dict(TINY_REM if name == "rem" else TINY, **opts)
    params = _params(name)
    jmodel = j_get_model(name, **config)
    model = get_model(name, **config)
    model.load_state_dict(from_jax_params(params, model))
    _JCODECS[key] = JPICCodec(jmodel, {"params": params})
    return (jmodel, _JCODECS[key], model, PICCodec(model, device="cpu"),
            params)


@functools.lru_cache(maxsize=None)
def _checkpoints(key):
    """The ``rem`` model's chained check-level latents of the test image,
    extracted by the port (each the previous one's ``checkpoint_rep``);
    both packages are conditioned on these. Each is bitwise the port's
    ``compress(return_latents=True)`` latent at its level, which
    test_compress_matches_jax holds to the JAX package's."""
    _, _, _, codec, _ = _setup(key)
    x = _image()
    out, prev = [], None
    for cl in codec.model.check_levels:
        enc = codec.compress(x, cl, return_latents=True, checkpoint_rep=prev)
        prev = codec.extract_checkpoint(x, cl, prev)
        assert torch.equal(prev, enc["y_hat"])
        out.append(prev)
    return out


# programs of a JAX codec that no option changes (front, hyperprior, base
# chain, synthesis, the LRP-and-merge reconstruction): the ``pic``
# configurations' codecs share them instead of compiling each again
SHARED_PROGRAMS = ("front", ("hyper", False), ("hyper", True),
                   "base_params_dyn", "base_sym", "base_step_dyn",
                   "base_finish_dyn", "base_chain_scan", "synth_base",
                   "synth_prog", "prog_reconstruct")


def _share_programs(key):
    """Lay the option-independent programs that the JAX codecs of the
    same model's other configurations compiled under key's."""
    jcodec = _setup(key)[1]
    for other, codec in _JCODECS.items():
        if other != key and CONFIGS[other][0] == CONFIGS[key][0]:
            for k in SHARED_PROGRAMS:
                if k in codec._jit_cache:
                    jcodec._jit_cache.setdefault(k, codec._jit_cache[k])


def _jax_forward(jmodel, params, x, ckpt):
    """The JAX forward of one configuration: multi-quality at MULTI_Q
    without a checkpoint latent, else single-quality at SINGLE_Q with it."""
    def run(p, xj, ck):
        if ck is None:
            return jmodel.apply({"params": p}, xj, MULTI_Q, False,
                                method=JPIC.__call__)
        return jmodel.apply({"params": p}, xj, SINGLE_Q, False, None, ck,
                            method=JPIC.forward_single_quality)

    args = (params, jnp.asarray(x), None if ckpt is None else
            jnp.asarray(ckpt))
    return jax.jit(run).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _close(got, want, atol, what):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def _check_out(out, jout, tag):
    assert set(out) == set(jout), (tag, set(out) ^ set(jout))
    for k, v in out.items():
        if k == "likelihoods":
            assert set(v) == set(jout[k])
            for lk, lik in v.items():
                _close(lik, jout[k][lk], ATOL, f"{tag} likelihoods {lk}")
        else:
            _close(v, jout[k], X_ATOL if k == "x_hat" else ATOL,
                   f"{tag} {k}")


@pytest.mark.parametrize("key", list(CONFIGS))
def test_forward_matches_jax(key):
    """The multi-quality forward at [0, 0.5, 10] (``pic``), or the
    single-quality forward at 0.5 REM-refined from the checkpoint latent at
    0.25 (``rem``; both packages get the port's latent), ``training=False``:
    every output against the JAX package's."""
    jmodel, _, model, _, params = _setup(key)
    x = _image()
    ck = _checkpoints(key)[0] if hasattr(model, "check_levels") else None
    jout = _jax_forward(jmodel, params, x, None if ck is None else ck.numpy())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = (model.multi_quality(xt, MULTI_Q, False) if ck is None else
               model.forward_single_quality(xt, SINGLE_Q, False, ck))
    _check_out(out, jout, key)


@pytest.mark.parametrize("option", [dict(all_scalable=False),
                                    dict(delta_encode=False),
                                    dict(total_mu_rep=False),
                                    dict(mask_policy="two-levels")],
                         ids=lambda o: next(iter(o)))
def test_each_option_changes_the_forward(option):
    """Each option alone moves the port's forward away from the default
    configuration's on the same weights (so that the combined
    configuration above holds each of them to the JAX package)."""
    default, out = _port_forward(()), _port_forward(tuple(option.items()))
    assert not torch.equal(default["x_hat"][1:], out["x_hat"][1:])
    assert torch.equal(default["x_hat"][0], out["x_hat"][0])


@functools.lru_cache(maxsize=None)
def _port_forward(options):
    model = get_model("pic", **TINY, **dict(options))
    model.load_state_dict(from_jax_params(_params("pic"), model))
    with torch.no_grad():
        return model.multi_quality(torch.from_numpy(_image()), MULTI_Q, False)


COMPRESS_CASES = [("pic-non_scalable", 0.5), ("pic-non_scalable", 10.0),
                  ("rem-non_scalable", 0.5), ("rem-non_scalable", 10.0),
                  ("pic-options_off", 0.5)]


@pytest.mark.parametrize("key,quality", COMPRESS_CASES)
def test_compress_matches_jax(key, quality):
    """Strings byte-equal to the JAX package's (a ``rem`` model
    conditioned on the port's check-level latent that brackets the quality
    from below) and the latent within tolerance of the JAX encoder's;
    the port's decoder bitwise its encoder (y_hat); each package decodes
    the other's strings into exactly what it decodes from its own; x_hat
    within tolerance of the JAX decode."""
    _, jcodec, model, codec, _ = _setup(key)
    _share_programs(key)
    x = _image()
    ck = jck = None
    if hasattr(model, "check_levels"):
        j = max(i for i, cl in enumerate(model.check_levels) if quality > cl)
        ck = _checkpoints(key)[j]
        jck = ck.numpy()
    out = codec.compress(x, quality, return_latents=True, checkpoint_rep=ck)
    jout = jcodec.compress(x, quality, return_latents=True,
                           checkpoint_rep=jck)
    ya, za = out["strings"]
    yb, zb = jout["strings"]
    assert za == zb and len(ya) == len(yb) == model.ns1
    for i, (sa, sb) in enumerate(zip(ya, yb)):
        assert sa == sb, f"slice {i}"
    _close(out["y_hat"], jout["y_hat"], ATOL, "y_hat")
    dec = codec.decompress({k: out[k] for k in KEYS}, checkpoint_rep=ck)
    assert torch.equal(dec["y_hat"], out["y_hat"])
    of_jax = codec.decompress({k: jout[k] for k in KEYS}, checkpoint_rep=ck)
    for k in ("x_hat", "y_hat"):
        assert torch.equal(of_jax[k], dec[k])
    # the JAX decoder runs its encoder's programs: its decode of its own
    # strings is bitwise its encoder's latent
    jof_port = jcodec.decompress({k: out[k] for k in KEYS},
                                 checkpoint_rep=jck)
    np.testing.assert_array_equal(np.asarray(jof_port["y_hat"]),
                                  np.asarray(jout["y_hat"]))
    _close(dec["x_hat"], jof_port["x_hat"], X_ATOL, "x_hat")


def test_progressive_encode_refuses_non_scalable():
    _, jcodec, _, codec, _ = _setup("pic-non_scalable")
    x = _image(b=1)
    with pytest.raises(ValueError) as want:
        j_progressive_encode(jcodec, x)
    with pytest.raises(ValueError) as got:
        progressive_encode(codec, x)
    assert str(got.value) == str(want.value)


def test_unknown_mask_policy_raises():
    scale = np.ones((1, 4, 4, 8), np.float32)
    with pytest.raises(NotImplementedError):
        j_variance_mask(jnp.asarray(scale), 0.5, "bogus")
    with pytest.raises(NotImplementedError, match="bogus"):
        variance_mask(torch.from_numpy(scale), 0.5, "bogus")
    model = get_model("pic", mask_policy="bogus", **TINY)
    with pytest.raises(NotImplementedError), torch.no_grad():
        model.forward_single_quality(torch.from_numpy(_image(b=1)), 0.5,
                                     False)
    # two-levels: all zeros at 0, all ones at any other quality
    t = torch.from_numpy(np.random.default_rng(0).random((2, 4, 4, 8),
                                                         np.float32))
    for q in (0, 0.01, 5, 10):
        np.testing.assert_array_equal(
            variance_mask(t, q, "two-levels").numpy(),
            np.asarray(j_variance_mask(jnp.asarray(t.numpy()), q,
                                       "two-levels")))


@pytest.mark.parametrize("key", ["rem-non_scalable", "pic-options_off"])
def test_params_map_one_to_one(key):
    """``to_jax_params`` of a model with the options gives the JAX tree it
    was loaded from back, leaf for leaf, bitwise."""
    _, _, model, _, params = _setup(key)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), np.asarray(v)

    got, want = dict(leaves(to_jax_params(model))), dict(leaves(params))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))
