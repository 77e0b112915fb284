"""Layers and transforms of the PyTorch port against the flax modules, with
the same weights carried across by ``from_jax_params``.

Weights are drawn with numpy into the exact parameter tree of each flax
module (its shapes from ``jax.eval_shape``), so nothing is trained or
initialised twice. Everything runs in float32 on the CPU; tolerance
atol 1e-4 (float32 sums in another order through up to ~30 layers). A lone
conv or dense layer in bfloat16 must equal flax's bitwise: the product is
rounded to bf16 before the bias is added, as flax does.
Random kernels are not spatially symmetric, so a flipped or shifted
transposed conv would show.
"""

import importlib
import math

import numpy as np
import pytest
import torch
from torch import nn
import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from epic_tpu_torch.convert import from_jax_params
from epic_tpu_torch.models import builder
from epic_tpu_torch.ops import attention
from epic_tpu_torch.ops import conv

# epic_tpu.ops re-exports functions named like its submodules
jbuilder = importlib.import_module("epic_tpu.models.builder")
jattention = importlib.import_module("epic_tpu.ops.attention")
jconv = importlib.import_module("epic_tpu.ops.conv")

ATOL = 1e-4
TINY = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))


def _leaf(path, shape, rng):
    name = path[-1]
    if name == "beta":
        return np.sqrt(1.0 + 0.1 * rng.random(shape))
    if name == "gamma":
        return np.sqrt(0.1 * np.eye(shape[0]) + 0.01 * rng.random(shape))
    if name == "kernel" or name.endswith("_kernel"):
        return rng.normal(0, 1, shape) / math.sqrt(np.prod(shape[:-1])
                                                   / (shape[0] if len(shape)
                                                      == 5 else 1))
    if name == "relative_position_bias_table":
        return rng.normal(0, 0.02, shape)
    if name == "quantiles":
        return np.sort(np.array([-10.0, 0.0, 10.0])
                       + rng.normal(0, 0.5, shape), axis=-1)
    if name.startswith("matrix_"):
        return math.log(math.expm1(10 ** -0.2)) + rng.normal(0, 0.1, shape)
    if name.startswith("bias_") and len(shape) == 3:
        return rng.uniform(-0.5, 0.5, shape)
    return rng.normal(0, 0.1, shape)  # conv / dense biases, EB factors


def random_params(shapes, seed: int = 0):
    """numpy float32 values for a flax parameter tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def fill(tree, path):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in sorted(tree.items())}
        return _leaf(path, tree.shape, rng).astype(np.float32)

    return fill(jax.tree_util.tree_map(lambda a: a, shapes), ())


def flax_params(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs))["params"]
    return random_params(dict(shapes), seed)


class Holder(nn.Module):
    """Names a lone torch layer as flax names it in its parent's tree."""

    def __init__(self, name, module):
        super().__init__()
        setattr(self, name, module)
        self.name = name

    def forward(self, *args):
        return getattr(self, self.name)(*args)


def check(flax_mod, torch_mod, x, name=None, **kwargs):
    xj = jnp.asarray(x)
    params = flax_params(flax_mod, xj, **kwargs)
    want = np.asarray(jax.jit(lambda p, a: flax_mod.apply(
        {"params": p}, a, **kwargs))(params, xj))
    if name is not None:
        params, torch_mod = {name: params}, Holder(name, torch_mod)
    torch_mod.load_state_dict(from_jax_params(params, torch_mod))
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(np.asarray(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["conv5s2", "conv3x3", "conv3x3s2",
                                  "conv1x1"])
def test_conv(kind):
    make = {"conv5s2": (lambda: jconv.conv(12), lambda: conv.conv(6, 12)),
            "conv3x3": (lambda: jconv.conv3x3(12),
                        lambda: conv.conv3x3(6, 12)),
            "conv3x3s2": (lambda: jconv.conv3x3(12, stride=2),
                          lambda: conv.conv3x3(6, 12, stride=2)),
            "conv1x1": (lambda: jconv.conv1x1(12),
                        lambda: conv.conv1x1(6, 12))}[kind]
    check(make[0](), make[1](), _x((2, 16, 12, 6)), name="Conv_0")


@pytest.mark.parametrize("kind", ["conv5s2", "conv3x3", "conv3x3s2",
                                  "conv1x1", "deconv", "subpel", "dense"])
def test_bf16_layer_bitwise(kind):
    bf, tbf = jnp.bfloat16, torch.bfloat16
    flax_mod, torch_mod, name, shape = {
        "conv5s2": (jconv.conv(12, dtype=bf), conv.conv(6, 12, tbf),
                    "Conv_0", (2, 16, 12, 6)),
        "conv3x3": (jconv.conv3x3(12, dtype=bf),
                    conv.conv3x3(6, 12, dtype=tbf), "Conv_0", (2, 16, 12, 6)),
        "conv3x3s2": (jconv.conv3x3(12, stride=2, dtype=bf),
                      conv.conv3x3(6, 12, stride=2, dtype=tbf), "Conv_0",
                      (2, 16, 12, 6)),
        "conv1x1": (jconv.conv1x1(12, dtype=bf), conv.conv1x1(6, 12, tbf),
                    "Conv_0", (2, 16, 12, 6)),
        "deconv": (jconv.deconv(5, dtype=bf), conv.deconv(6, 5, tbf),
                   "ConvTranspose_0", (2, 6, 5, 6)),
        "subpel": (jconv.SubpelConv(4, 2, dtype=bf),
                   conv.SubpelConv(6, 4, 2, tbf), "SubpelConv_0",
                   (1, 5, 4, 6)),
        "dense": (flax_nn.Dense(40, dtype=bf), attention.Dense(24, 40, tbf),
                  "Dense_0", (4, 16, 24)),
    }[kind]
    x = _x(shape, 5)
    params = flax_params(flax_mod, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, a: flax_mod.apply({"params": p}, a))(
        params, jnp.asarray(x))).astype(np.float32)
    torch_mod = Holder(name, torch_mod)
    torch_mod.load_state_dict(from_jax_params({name: params}, torch_mod))
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x))
    assert got.dtype == tbf
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_deconv_asymmetric_kernel():
    check(jconv.deconv(5), conv.deconv(6, 5), _x((2, 6, 5, 6)),
          name="ConvTranspose_0")


def test_subpel_conv():
    check(jconv.SubpelConv(4, 2), conv.SubpelConv(6, 4, 2), _x((1, 5, 4, 6)),
          name="SubpelConv_0")


@pytest.mark.parametrize("window,shift", [(8, 4), (4, 2)])
def test_window_attention_block(window, shift):
    dim = 16
    check(jattention.WinNoShiftAttention(dim, 8, window, shift),
          attention.WinNoShiftAttention(dim, 8, window, shift),
          _x((2, 2 * window, 2 * window, dim)))


def test_window_partition_roundtrip():
    x = torch.from_numpy(_x((2, 8, 16, 3)))
    w = attention.window_partition(x, 4)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jattention.window_partition(jnp.asarray(
            x.numpy()), 4)))
    assert torch.equal(attention.window_reverse(w, 4, 8, 16), x)


@pytest.mark.parametrize("name", ["g_a", "g_s", "h_a", "h_s"])
def test_transforms_tiny(name):
    n, m, d0 = TINY["n"], TINY["m"], TINY["division"][0]
    flax_mod, torch_mod, shape = {
        "g_a": (jbuilder.AnalysisTransform(n, d0),
                builder.AnalysisTransform(n, d0), (1, 64, 64, 3)),
        "g_s": (jbuilder.SynthesisTransform(n, d0),
                builder.SynthesisTransform(n, d0), (1, 4, 4, d0)),
        "h_a": (jbuilder.HyperAnalysis(n), builder.HyperAnalysis(m, n),
                (1, 4, 4, m)),
        "h_s": (jbuilder.HyperSynthesis(d0), builder.HyperSynthesis(n, d0),
                (1, 1, 1, n)),
    }[name]
    x = _x(shape, 1)
    if name == "g_a":
        x = np.abs(x) % 1.0
    check(flax_mod, torch_mod, x)


def test_stacked_paramnet():
    s, in_w = 3, 12
    flax_mod = jbuilder.StackedParamNet(s, in_w, 8, (10, 6))
    x = _x((2, 4, 4, in_w), 2)
    params = flax_params(flax_mod, jnp.asarray(x), 0)
    torch_mod = builder.StackedParamNet(s, in_w, 8, (10, 6))
    torch_mod.load_state_dict(from_jax_params(params, torch_mod))
    for i in range(s):
        want = np.asarray(flax_mod.apply({"params": params},
                                         jnp.asarray(x), i))
        got = torch_mod(torch.from_numpy(x), i).detach().numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
