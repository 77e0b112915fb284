"""Fused GDN of the PyTorch port against the JAX package.

The port's plain GDN / inverse GDN (the CPU path of ``gdn``) is held to the
Pallas kernel in interpret mode and to the einsum form at rtol 1e-5 (float32
sums of C products in another order), including a ragged 21-row case; the
``GDN`` module with weights carried across is held to the flax module, in
float32 and at bf16 (within one bf16 ulp: the two round the same float32
result, computed in another order). bf16 x goes in and comes out as bf16,
bitwise the float32 result rounded; the wrapper's checks refuse the types
and layouts the kernel does not take. The CUDA kernel itself is compared
with the plain version on the card by tests/test_torch_gdn_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.ops.gdn import GDN as FlaxGDN
from epic_tpu.ops.pallas_gdn import gdn_pallas
from epic_tpu_torch.convert import from_jax_params
from epic_tpu_torch.entropy.ops import nn_param_apply
from epic_tpu_torch.ops.gdn import _BETA_MIN, GDN
from epic_tpu_torch.ops.gdn_kernel import (_check, gdn, gdn_differentiable,
                                           gdn_plain)

RTOL, ATOL = 1e-5, 1e-6


def _jax_einsum(x, gamma, beta, inverse):
    norm = jnp.einsum("bhwj,ji->bhwi", jnp.square(x), gamma) + beta
    return x * jnp.sqrt(norm) if inverse else x * jax.lax.rsqrt(norm)


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    beta = (1.0 + 0.1 * rng.random(c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [(2, 8, 12, 32), (1, 3, 7, 32)],
                         ids=["aligned", "ragged21"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_plain_matches_pallas_and_einsum(shape, inverse):
    x, gamma, beta = _data(shape)
    got = gdn(torch.from_numpy(x), torch.from_numpy(gamma),
              torch.from_numpy(beta), inverse).numpy()
    pallas = np.asarray(gdn_pallas(jnp.asarray(x), jnp.asarray(gamma),
                                   jnp.asarray(beta), inverse, True))
    einsum = np.asarray(_jax_einsum(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), inverse))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, einsum, rtol=RTOL, atol=ATOL)


def test_cpu_tensor_takes_the_plain_version():
    x, gamma, beta = (torch.from_numpy(a) for a in _data((1, 3, 7, 16), 3))
    before = dict(gdn.launches)
    for inverse in (False, True):
        assert torch.equal(gdn(x, gamma, beta, inverse),
                           gdn_plain(x, gamma, beta, inverse))
    assert gdn.launches == before


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_module_matches_flax_with_carried_weights(inverse):
    c = 16
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 4, 4, c)).astype(np.float32)
    flax_mod = FlaxGDN(c, inverse=inverse, use_pallas=False)
    shapes = jax.eval_shape(flax_mod.init, jax.random.key(0),
                            jnp.asarray(x))["params"]
    params = {"beta": np.sqrt(1.0 + rng.random(c)).astype(np.float32),
              "gamma": np.sqrt(0.1 * np.eye(c) + 0.02 * rng.random((c, c)))
              .astype(np.float32)}
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: v.shape for k, v in params.items()}
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x)))
    mod = GDN(c, inverse)
    mod.load_state_dict(from_jax_params(params, mod))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_in_gives_bf16_out_bitwise_the_float32_rounded():
    """gdn_plain and the GDN module take bf16 x as it comes (no cast around
    the call) and give bf16 y, bitwise gdn_plain(x.float()) rounded."""
    x, gamma, beta = (torch.from_numpy(a) for a in _data((2, 5, 3, 24), 5))
    xb = x.bfloat16()
    for inverse in (False, True):
        want = gdn_plain(xb.float(), gamma, beta, inverse).to(torch.bfloat16)
        got = gdn_plain(xb, gamma, beta, inverse)
        assert got.dtype is torch.bfloat16 and torch.equal(got, want)
        mod = GDN(24, inverse)
        with torch.no_grad():
            y = mod(xb)
            ref = gdn_plain(xb.float(), nn_param_apply(mod.gamma, 0.0),
                            nn_param_apply(mod.beta, _BETA_MIN),
                            inverse).to(torch.bfloat16)
        assert y.dtype is torch.bfloat16 and torch.equal(y, ref)


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_module_bf16_matches_flax_bf16_within_one_ulp(inverse):
    """The port's bf16 GDN against flax's at bf16 (float32 inside, y cast
    back: epic_tpu/ops/gdn.py), weights carried across: within one bf16 ulp
    of the larger magnitude."""
    c = 16
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, (2, 4, 4, c)).astype(np.float32)
    flax_mod = FlaxGDN(c, inverse=inverse, use_pallas=False)
    params = {"beta": np.sqrt(1.0 + rng.random(c)).astype(np.float32),
              "gamma": np.sqrt(0.1 * np.eye(c) + 0.02 * rng.random((c, c)))
              .astype(np.float32)}
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    want = np.asarray(flax_mod.apply({"params": params}, xj)
                      .astype(jnp.float32))
    mod = GDN(c, inverse)
    mod.load_state_dict(from_jax_params(params, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).bfloat16())
    assert got.dtype is torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), np.abs(got))))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_check_refuses_what_the_kernel_cannot_take():
    x, gamma, beta = (torch.from_numpy(a) for a in _data((8, 16), 2))
    _check("gdn", x, gamma, beta, x_types=(torch.float32, torch.bfloat16))
    _check("gdn", x.bfloat16(), gamma, beta,
           x_types=(torch.float32, torch.bfloat16))
    for bad in (x.half(), x.double(), x.t().contiguous().t()):
        with pytest.raises(ValueError):
            _check("gdn", bad, gamma, beta,
                   x_types=(torch.float32, torch.bfloat16))
    with pytest.raises(ValueError):  # the backward keeps float32 only
        _check("gdn_backward", x.bfloat16(), gamma, beta)
    c = 193
    with pytest.raises(ValueError):
        _check("gdn", torch.zeros(4, c), torch.zeros(c, c), torch.ones(c),
               x_types=(torch.float32, torch.bfloat16))


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_bf16_gradients_bitwise_the_float32_path(inverse):
    """Through the autograd function, bf16 x gives dx (bf16), dgamma and
    dbeta bitwise those of the same step on x.float() with y cast back."""
    x, gamma, beta = (torch.from_numpy(a) for a in _data((3, 4, 5, 16), 11))
    xb = x.bfloat16()
    w = torch.from_numpy(_data((3, 4, 5, 16), 12)[0])
    grads = []
    for path in ("bf16", "float32"):
        xi = xb.clone().requires_grad_(True)
        gi = gamma.clone().requires_grad_(True)
        bi = beta.clone().requires_grad_(True)
        if path == "bf16":
            y = gdn_differentiable(xi, gi, bi, inverse)
        else:
            y = gdn_differentiable(xi.float(), gi, bi, inverse).bfloat16()
        assert y.dtype is torch.bfloat16
        (y.float() * w).sum().backward()
        grads.append((xi.grad, gi.grad, bi.grad))
    assert grads[0][0].dtype is torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(*grads))
