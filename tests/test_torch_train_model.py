"""The training halves of the port's modules against the JAX package, on
the CPU.

- GDN / IGDN backward: ``gdn_backward`` (the plain closed form on the CPU)
  against ``jax.grad`` through the JAX package's ``gdn_pallas`` in
  interpret mode (whose custom_vjp is the closed form) and against
  autograd through ``gdn_plain``; the ``GDN`` module's gradients (through
  the reparametrisation) against the flax module's. Float32 sums in
  another order: dx within 1e-5 of its largest magnitude, dgamma / dbeta
  (sums over every row) within 1e-5 relative to theirs.
- The autograd function launches nothing on the CPU and, under no_grad,
  is ``gdn`` itself.
- Training noise: every draw in [-0.5, 0.5], masked where asked, the same
  generator seed giving bitwise the same values (and the same training
  forward), another seed other values.
- The bottleneck's aux loss and its gradients (the quantiles' only)
  against the JAX package's, within 1e-5 relative.
- bfloat16: the single-quality training forward at quality 10
  (``training=False``) and
  the refine_gs_ga loss held to twice the reference's own bf16-vs-float32
  difference, as test_torch_pic.py does for the codec.
The float32 forwards, the criteria and full steps of every stage are held
to the JAX package in test_torch_train_step.py and test_torch_train_cli.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.entropy.bottleneck import EntropyBottleneck as JBottleneck
from epic_tpu.ops.gdn import GDN as FlaxGDN
from epic_tpu.ops.pallas_gdn import gdn_pallas
from epic_tpu.training.losses import CRITERIA as J_CRITERIA
from epic_tpu_torch.convert import from_jax_params
from epic_tpu_torch.entropy.bottleneck import EntropyBottleneck
from epic_tpu_torch.entropy.gaussian import gaussian_noise_quantize
from epic_tpu_torch.models import get_model
from epic_tpu_torch.ops.gdn import GDN
from epic_tpu_torch.ops.gdn_kernel import (gdn, gdn_backward,
                                           gdn_backward_plain,
                                           gdn_differentiable, gdn_plain)
from epic_tpu_torch.ops.masking import apply_noise_mask
from epic_tpu_torch.training.losses import CRITERIA
from test_torch_layers import random_params
from test_torch_train_step import FAST_COMPILE, TINY, batch, tiny_pair
from test_torch_train_step import one_torch_thread  # noqa: F401


def _gdn_data(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    beta = (1.0 + 0.1 * rng.random(c)).astype(np.float32)
    return x, gamma, beta, g


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 8, 12, 32), (1, 3, 7, 32)],
                         ids=["aligned", "ragged21"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_matches_pallas_vjp_and_autograd(shape, inverse):
    x, gamma, beta, g = _gdn_data(shape)
    jx, jgm, jb = (jnp.asarray(a) for a in (x, gamma, beta))
    _, vjp = jax.vjp(lambda a, b, c: gdn_pallas(a, b, c, inverse, True),
                     jx, jgm, jb)
    want = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (x, gamma, beta, g)]
    before = dict(gdn_backward.launches)
    got = gdn_backward(*t, inverse)
    assert gdn_backward.launches == before
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    xr, gr, br = (a.clone().requires_grad_() for a in t[:3])
    auto = torch.autograd.grad(gdn_plain(xr, gr, br, inverse), (xr, gr, br),
                               t[3])
    for a, b in zip(got, auto):
        _close(a.numpy(), b.numpy())
    for a, b in zip(gdn_backward_plain(*t, inverse), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_gdn_module_gradients_match_flax(inverse):
    """dL/dx and the gradients of the reparametrised beta / gamma of the
    GDN module, L = sum(y * w), against the flax module's (einsum path)."""
    c = 16
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 4, 4, c)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    params = {"beta": np.sqrt(1.0 + rng.random(c)).astype(np.float32),
              "gamma": np.sqrt(0.1 * np.eye(c) + 0.02 * rng.random((c, c)))
              .astype(np.float32)}
    flax_mod = FlaxGDN(c, inverse=inverse, use_pallas=False)
    (jp, jx) = jax.grad(lambda p, a: jnp.sum(flax_mod.apply(
        {"params": p}, a) * w), argnums=(0, 1))(params, jnp.asarray(x))
    mod = GDN(c, inverse)
    mod.load_state_dict(from_jax_params(params, mod))
    xt = torch.from_numpy(x).requires_grad_()
    (mod(xt) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), jx)
    _close(mod.beta.grad.numpy(), jp["beta"])
    _close(mod.gamma.grad.numpy(), jp["gamma"])


def test_no_grad_is_the_plain_call():
    x, gamma, beta, _ = (torch.from_numpy(a) for a in _gdn_data((1, 3, 7, 8)))
    gamma.requires_grad_()
    y = gdn_differentiable(x, gamma, beta)
    assert y.grad_fn is not None
    with torch.no_grad():
        y = gdn_differentiable(x, gamma, beta)
    assert y.grad_fn is None and torch.equal(y, gdn(x, gamma, beta))


def test_noise_range_mask_and_determinism():
    x = torch.zeros(4, 8, 8, 16)
    mask = (torch.arange(16) % 2).to(torch.float32).expand(4, 8, 8, 16)
    a = gaussian_noise_quantize(x, torch.Generator().manual_seed(3), mask)
    b = gaussian_noise_quantize(x, torch.Generator().manual_seed(3), mask)
    c = gaussian_noise_quantize(x, torch.Generator().manual_seed(4), mask)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 0.5 and float(a[..., 1::2].abs().min()) > 0
    assert torch.all(a[..., 0::2] == 0)
    eb = EntropyBottleneck(16)
    z = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    out, lik = eb(z, True, torch.Generator().manual_seed(1))
    d = out - z
    assert float(d.abs().max()) <= 0.5 and float(d.std()) > 0.2
    assert bool(((lik > 0) & (lik <= 1)).all())
    m = torch.tensor([0.2, 0.7, 1.0]).requires_grad_()
    r = apply_noise_mask(m, True)
    r.sum().backward()
    assert torch.equal(r.detach(), torch.tensor([0.0, 1.0, 1.0]))
    assert torch.equal(m.grad, torch.ones(3))
    assert torch.equal(apply_noise_mask(m.detach(), False), r.detach())


def test_training_forward_same_seed_same_bits():
    """Noise from a generator: the same seed gives bitwise the same
    training forward; another seed another one. Rounding is straight
    through, so every parameter that shapes x_hat gets a gradient."""
    model = get_model("pic", **TINY).init_weights(0)
    x = torch.from_numpy(batch())
    outs = [model(x, [0, 10], True, torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    for k in ("y", "y_prog", "z"):
        assert torch.equal(outs[0]["likelihoods"][k],
                           outs[1]["likelihoods"][k])
    assert torch.equal(outs[0]["x_hat"], outs[1]["x_hat"])
    assert not torch.equal(outs[0]["likelihoods"]["z"],
                           outs[2]["likelihoods"]["z"])
    loss = CRITERIA["first_train"](outs[0], x)["loss"]
    assert torch.isfinite(loss)
    loss.backward()
    assert model.g_a_0.Conv_0.weight.grad.abs().sum() > 0
    assert model.g_s_1.GDN_0.gamma.grad.abs().sum() > 0


def test_aux_loss_matches_jax():
    c = 8
    jmod = JBottleneck(c)
    z = jnp.zeros((1, 2, 2, c))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), z,
                                              False))["params"]
    params = random_params(dict(shapes), seed=3)
    params["quantiles"] = np.tile(np.array([-8.0, 0.5, 9.0], np.float32),
                                  (c, 1, 1))
    want, jg = jax.value_and_grad(lambda p: jmod.apply(
        {"params": p}, method=JBottleneck.aux_loss))(params)
    mod = EntropyBottleneck(c)
    mod.load_state_dict(from_jax_params(params, mod))
    got = mod.aux_loss()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(mod.quantiles.grad.numpy(), jg["quantiles"])
    assert all(p.grad is None for n, p in mod.named_parameters()
               if n != "quantiles")


def test_bf16_training_forward_within_its_own_bf16_error(record_property):
    """The single-quality forward at quality 10 (training=False) and the
    refine_gs_ga loss in bfloat16, on the same weights: each difference
    from the reference's bf16 held to twice the reference's own
    bf16-vs-float32 difference, or to the float32 parity tolerance (1e-5
    of the largest value) where that is larger (z's likelihoods come out
    bitwise equal in the reference's two precisions, and the port's differ
    from them by one float32 unit). At quality 10 every element is
    transmitted: at a lower quality a bf16 rounding can move an element
    across the variance mask's threshold, and the reference's own bf16 rate
    then moves by 10x its float32 difference between its eager and jitted
    runs (0.5: 0.31682 against 0.32257 bits, float32 0.32314); the codec's
    mask flips are held by test_torch_pic.py."""
    jmodel, params, _ = tiny_pair("pic")
    x = batch(2)
    xj = jnp.asarray(x)
    jm16 = type(jmodel)(**dict(TINY, compute_dtype="bfloat16"))
    ref = {}
    for tag, jm in (("bf16", jm16), ("f32", jmodel)):
        def fwd(p, jm=jm):
            out = jm.apply({"params": p}, xj, 10.0, False,
                           method=type(jm).forward_single_quality)
            return out, J_CRITERIA["refine_gs_ga"](out, xj, 0.04)

        ref[tag] = jax.jit(fwd).lower(params).compile(
            compiler_options=FAST_COMPILE)(params)
    model = get_model("pic", **dict(TINY, compute_dtype="bfloat16"))
    model.load_state_dict(from_jax_params(params, model))
    with torch.no_grad():
        out = model.forward_single_quality(torch.from_numpy(x), 10.0, False)
        loss = CRITERIA["refine_gs_ga"](out, torch.from_numpy(x), 0.04)
    report = {}
    pairs = [("x_hat", out["x_hat"], lambda o: o[0]["x_hat"]),
             ("y_hat", out["y_hat"], lambda o: o[0]["y_hat"]),
             ("loss", loss["loss"], lambda o: o[1]["loss"]),
             ("bpp_loss", loss["bpp_loss"], lambda o: o[1]["bpp_loss"])]
    pairs += [(f"likelihoods {k}", out["likelihoods"][k],
               (lambda k: lambda o: o[0]["likelihoods"][k])(k))
              for k in ("y", "z")]
    for name, got, pick in pairs:
        r16 = np.asarray(pick(ref["bf16"]), np.float32)
        r32 = np.asarray(pick(ref["f32"]), np.float32)
        diff = float(np.abs(got.float().numpy() - r16).max())
        own = float(np.abs(r16 - r32).max())
        report[name] = (diff, own)
        assert diff <= max(2 * own, 1e-5 * np.abs(r16).max()), \
            (name, diff, own)
    record_property("max abs diff (reference's own bf16 vs f32)",
                    str(report))
