"""Fused GDN of the PyTorch port against the JAX package.

The port's plain GDN / inverse GDN (the CPU path of ``gdn``) is held to the
Pallas kernel in interpret mode and to the einsum form at rtol 1e-5 (float32
sums of C products in another order), including a ragged 21-row case; the
``GDN`` module with weights carried across is held to the flax module, in
float32 and at bf16 (within one bf16 ulp: the two round the same float32
result, computed in another order). bf16 x goes in and comes out as bf16,
bitwise the float32 result rounded; the wrapper's checks refuse the types
and layouts the kernels do not take; the backward's plain route takes bf16
x and g as their widened values, and the backward kernel's per-cluster
partials sum to dgamma and dbeta. The CUDA kernel itself is compared
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
from epic_tpu_torch.ops.gdn_kernel import (MAX_CHANNELS, PART_ROWS, _check,
                                           gdn, gdn_backward,
                                           gdn_backward_plain,
                                           gdn_backward_reduce,
                                           gdn_backward_rows_plain,
                                           gdn_differentiable, gdn_plain)

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
    """Both kernels take float32 or bf16 x (the backward's g of x's type),
    contiguous, 1 <= C <= 192, gamma and beta float32."""
    x, gamma, beta = (torch.from_numpy(a) for a in _data((8, 16), 2))
    for xt in (x, x.bfloat16()):
        _check("gdn", xt, gamma, beta)
        _check("gdn_backward", xt, gamma, beta, xt.clone())
    for bad in (x.half(), x.double(), x.t().contiguous().t()):
        with pytest.raises(ValueError):
            _check("gdn", bad, gamma, beta)
    for xt, g in ((x, x.bfloat16()), (x.bfloat16(), x), (x.half(), x.half()),
                  (x, x.t().contiguous().t())):
        with pytest.raises(ValueError):  # mixed types, float16, layout
            _check("gdn_backward", xt, gamma, beta, g)
    c = 193
    for name, others in (("gdn", ()), ("gdn_backward", (torch.zeros(4, c),))):
        with pytest.raises(ValueError):
            _check(name, torch.zeros(4, c), torch.zeros(c, c), torch.ones(c),
                   *others)


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_plain_route_takes_bf16_as_the_widened_values(inverse):
    """On the CPU, gdn_backward of bf16 x and g: bitwise
    gdn_backward_plain on the widened values, dx rounded once to bf16."""
    x, gamma, beta = (torch.from_numpy(a) for a in _data((2, 3, 7, 24), 13))
    g = torch.from_numpy(_data((2, 3, 7, 24), 14)[0])
    xb, gb = x.bfloat16(), g.bfloat16()
    dx, dgamma, dbeta = gdn_backward(xb, gamma, beta, gb, inverse)
    want = gdn_backward_plain(xb.float(), gamma, beta, gb.float(), inverse)
    assert dx.dtype is torch.bfloat16
    assert torch.equal(dx, want[0].to(torch.bfloat16))
    assert torch.equal(dgamma, want[1]) and torch.equal(dbeta, want[2])


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_partials_sum_to_the_weight_gradients(inverse):
    """The backward kernel's contract with its reduction: per cluster a
    partial [PART_ROWS, 192] holding sum (x^2)^T u over its rows (dgamma's
    rows, zero past C) and sum u (row 192); gdn_backward_reduce (on the CPU
    its plain version) scales the sum of the partials by -/+ 1/2, which is
    gdn_backward_plain's dgamma and dbeta."""
    c, parts = 40, 3
    x, gamma, beta = (torch.from_numpy(a) for a in _data((90, c), 15))
    g = torch.from_numpy(_data((90, c), 16)[0])
    _, u = gdn_backward_rows_plain(x, gamma, beta, g, inverse)
    part = torch.zeros(parts + 1, PART_ROWS, MAX_CHANNELS)
    for k, rows in enumerate(torch.arange(90).chunk(parts)):
        part[k, :c, :c] = (x[rows] ** 2).T @ u[rows]
        part[k, MAX_CHANNELS, :c] = u[rows].sum(0)
    dgamma, dbeta = gdn_backward_reduce(part.flatten(), parts, c, inverse)
    _, want_g, want_b = gdn_backward_plain(x, gamma, beta, g, inverse)
    # norm-wise (u is signed: a sum in another order may cancel elsewhere)
    for got, want in ((dgamma, want_g), (dbeta, want_b)):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
