"""The port's training state and step against the JAX package.

- Stage plans (every quality grid and lambda schedule) and the trainable /
  quantile masks equal the JAX package's, on the tiny ``rem`` model's
  parameter names.
- The optimizers against optax on a small tree for a few steps: the
  global-norm clip (over frozen gradients too), frozen parameters with no
  state and bitwise unchanged, Adam, the aux optimizer, a non-finite
  gradient skipped (parameters and moments untouched, the next step
  applied), the 21st consecutive one applied, and a learning-rate change
  that keeps the moments. Float32 elementwise work in the same order:
  within 1e-6 relative.
- One full step of the first_train stage on the tiny ``pic`` model
  (64x64, float32, ``training=False``: rounding instead of noise, so both
  sides compute the same function) against a JAX step built from the
  package's public pieces (``CRITERIA``, ``create_train_state``,
  ``apply_main`` / ``apply_aux``, ``aux_loss``; ``jax_steps``), with the
  multi-quality forward and the four criteria on it. The other stages'
  steps are in test_torch_train_refine.py and test_torch_train_rems.py,
  so that the files run on several workers. Tolerances (``check_step``):
  loss within 1e-5 relative;
  gradients before the clip within 1e-4 of each tensor's largest
  magnitude (float32 through the whole network in another order); the clip
  scale within 1e-5; first moments as the gradients, second moments within
  2e-4 of each tensor's largest (squares double the relative error).
  Parameters: Adam's first update is -lr g / (|g| + 1e-8), about -lr
  sign(g), so where |g| is near zero a tiny difference in g can move it by
  up to 2 lr; every parameter is held to that (2e-4 + 1e-6), and those
  whose gradient exceeds 1e-5 of the tensor's largest to 1e-6 absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from epic_tpu.models import get_model as j_get_model
from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
from epic_tpu.training import create_train_state as j_create_train_state
from epic_tpu.training import make_stage as j_make_stage
from epic_tpu.training.losses import CRITERIA as J_CRITERIA
from epic_tpu.training.stages import quantiles_mask as j_quantiles_mask
from epic_tpu.training.stages import trainable_mask as j_trainable_mask
from epic_tpu.training.state import get_learning_rate as j_get_lr
from epic_tpu.training.state import set_learning_rate as j_set_lr
from epic_tpu_torch import from_jax_params, get_model
from epic_tpu_torch.convert import _convert_leaf
from epic_tpu_torch.training.losses import CRITERIA
from epic_tpu_torch.training.stages import (make_stage, quantiles_mask,
                                            trainable_mask)
from epic_tpu_torch.training.state import (TrainState, get_learning_rate,
                                           set_learning_rate)
from epic_tpu_torch.training.step import make_train_step
from test_torch_layers import random_params

TINY = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))
TINY_REM = dict(TINY, check_levels=(0.25, 0.75), rem_dimension="middle")
CHECK_LEVELS, CHECK_LEVELS_NP = (0.25, 0.75), (4, 4)
LR = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU kernels on one thread while these tests run: the suite
    runs several test processes on the machine's cores at once, and
    torch's intra-op threads, each process as many as there are cores,
    then wait on one another (measured: 25x slower than alone). The tiny
    model gains little from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_pair(name="pic", seed=5):
    """(JAX model, its numpy params, the port model with them)."""
    jmodel = j_get_model(name, **(TINY_REM if name == "rem" else TINY))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), method="init_all"))["params"]
    params = random_params(dict(shapes), seed=seed)
    model = get_model(name, **(TINY_REM if name == "rem" else TINY))
    model.load_state_dict(from_jax_params(params, model))
    return jmodel, params, model


def port_model(name, params):
    """A fresh port model with the JAX params."""
    model = get_model(name, **(TINY_REM if name == "rem" else TINY))
    model.load_state_dict(from_jax_params(params, model))
    return model


def batch(seed=0):
    return np.random.default_rng(seed).random((2, 64, 64, 3),
                                              dtype=np.float32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def port_names(tree):
    """{port parameter name: JAX leaf} over a param-shaped tree (leaves
    that are not arrays, optax's MaskedNode, are left out); arrays go
    through the same transposes as from_jax_params."""
    out = {}
    for path, leaf in _flat(tree):
        if not hasattr(leaf, "shape"):
            continue
        key, t = _convert_leaf(path, torch.from_numpy(
            np.array(leaf, np.float32)))
        out[key] = t
    return out


def adam_moments(opt_state):
    """The first ScaleByAdamState inside an optax state: (mu, nu)."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state.mu, opt_state.nu
    children = (opt_state.values() if isinstance(opt_state, dict)
                else opt_state if isinstance(opt_state, tuple) else ())
    for c in children:
        found = adam_moments(c)
        if found is not None:
            return found
    return None


def jax_steps(jmodel, params, stages, x, quality=None, ckpt=None):
    """One step of each of ``stages`` ([(stage, lambda)], all of them
    multi-quality or all at ``quality``) from the same parameters, from the
    JAX package's public pieces, training=False, in one program that runs
    the forward once: [(state after, criterion outputs, gradients, forward
    outputs)]."""
    plans = [j_make_stage(st, check_levels=CHECK_LEVELS,
                          check_levels_np=CHECK_LEVELS_NP)
             for st, _ in stages]
    xj = jnp.asarray(x)

    @jax.jit
    def run(params, q, lmbdas, ckpt):
        if plans[0].sampling:
            out, vjp = jax.vjp(lambda p: jmodel.apply(
                {"params": p}, xj, q, False, None, ckpt,
                method=JPIC.forward_single_quality), params)
        else:
            out, vjp = jax.vjp(lambda p: jmodel.apply(
                {"params": p}, xj, list(plans[0].list_quality), False),
                params)
        res = []
        for (stage, _), plan, lm in zip(stages, plans, lmbdas):
            crit = J_CRITERIA[plan.criterion]
            lm = lm if plan.sampling else jnp.asarray(plan.lmbda_list,
                                                      jnp.float32)
            d = crit(out, xj, lm)
            g = vjp(jax.grad(lambda o: crit(o, xj, lm)["loss"])(out))[0]
            state = j_create_train_state(params, stage).apply_main(g)
            ag = jax.grad(lambda p: jmodel.apply(
                {"params": p}, method=JPIC.aux_loss))(state.params)
            res.append((state.apply_aux(ag), d, g, out))
        return res

    args = (params, None if quality is None else jnp.float32(quality),
            [jnp.float32(0.0 if lm is None else lm) for _, lm in stages],
            None if ckpt is None else jnp.asarray(ckpt))
    # XLA's cheapest backend optimization: the compile is most of the
    # test's time, and float32 results agree within the tolerances
    return run.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def port_step(model, stage, x, quality=None, lmbda=None, ckpt=None):
    """The port's step, training=False: (state, metrics, info, forward
    outputs at the parameters before the step)."""
    plan = make_stage(stage, check_levels=CHECK_LEVELS,
                      check_levels_np=CHECK_LEVELS_NP)
    ck = None if ckpt is None else torch.from_numpy(np.asarray(ckpt))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = (model.forward_single_quality(xt, quality, False, ck)
               if plan.sampling else model(xt, list(plan.list_quality),
                                           False))
    state = TrainState(model, stage)
    step = make_train_step(model, plan, training=False)
    metrics = step.loss(xt, None, quality, lmbda, ck)
    info = step.apply(state, metrics["loss"])
    return state, metrics, info, out


def check_forward(jout, out, x, lmbda):
    """The forward's outputs (x_hat, y_hat of a single-quality forward and
    every likelihood within 1e-5: float32 in another order) and all four
    criteria on them (within 1e-5 relative)."""
    np.testing.assert_allclose(out["x_hat"].numpy(),
                               np.asarray(jout["x_hat"]), atol=1e-5, rtol=0)
    if "y_hat" in jout:
        np.testing.assert_allclose(out["y_hat"].numpy(),
                                   np.asarray(jout["y_hat"]), atol=1e-5,
                                   rtol=0)
    assert set(out["likelihoods"]) == set(jout["likelihoods"])
    for k, lik in out["likelihoods"].items():
        np.testing.assert_allclose(lik.numpy(),
                                   np.asarray(jout["likelihoods"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for name, crit in CRITERIA.items():
        want = J_CRITERIA[name](jout, xj, jnp.asarray(lmbda, jnp.float32))
        got = crit(out, xt, lmbda)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k}")


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_step(jres, pres, record_property=None):
    """Hold the port's step to the JAX step (tolerances in the module
    docstring). Returns the worst differences."""
    jstate, jd, jg, _ = jres
    state, metrics, info, _ = pres
    worst = {}
    np.testing.assert_allclose(float(metrics["loss"].detach()),
                               float(jd["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["mse_loss"].detach().numpy(),
                               np.asarray(jd["mse_loss"]), rtol=1e-5)
    # gradients before the clip, every parameter
    jgrads = port_names(jg)
    assert set(jgrads) == set(state.names)
    g_rel = 0.0
    for name, g in zip(state.names, info["grads"]):
        want = jgrads[name].numpy()
        err = np.abs(g.numpy() - want).max()
        scale = np.abs(want).max()
        assert err <= 1e-4 * scale + 1e-12, (name, err, scale)
        g_rel = max(g_rel, err / max(scale, 1e-30))
    worst["grads"] = g_rel
    jnorm = float(np.sqrt(sum(np.sum(np.square(g.numpy(), dtype=np.float64))
                              for g in jgrads.values())))
    np.testing.assert_allclose(info["grad_norm"], jnorm, rtol=1e-5)
    np.testing.assert_allclose(info["clip_scale"], min(1.0, 1.0 / jnorm),
                               rtol=1e-5)
    # parameters after the step (main then aux)
    jparams = port_names(jstate.params)
    p_far = p_near = 0.0
    for name, p, g in zip(state.names, state.params, info["grads"]):
        got, want = p.detach().numpy(), jparams[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR + 1e-6, (name, diff.max())
        gj = np.abs(jgrads[name].numpy())
        big = gj > 1e-5 * max(gj.max(), 1e-30)
        if big.any():
            assert diff[big].max() <= 1e-6, (name, diff[big].max())
            p_far = max(p_far, float(diff[big].max()))
        p_near = max(p_near, float(diff.max()))
    worst["params (|g| > 1e-5 max)"] = p_far
    worst["params"] = p_near
    # Adam moments of the trainable parameters
    mu, nu = (port_names(t) for t in adam_moments(jstate.opt_state))
    assert set(mu) == set(state.trainable_names)
    for name, m, v in zip(state.trainable_names, state.main.mu,
                          state.main.nu):
        assert _rel(m.numpy(), mu[name].numpy()) <= 1e-4, name
        assert _rel(v.numpy(), nu[name].numpy()) <= 2e-4, name
    amu, anu = (port_names(t) for t in adam_moments(jstate.aux_opt_state))
    assert set(amu) == set(state.aux_names)
    for name, m in zip(state.aux_names, state.aux.mu):
        assert _rel(m.numpy(), amu[name].numpy()) <= 1e-4, name
    if record_property is not None:
        record_property("worst", str(worst))
    return worst


# ---- stages and masks ----

@pytest.mark.parametrize("stage", ["first_train", "refine_gs",
                                   "refine_gs_ga", "rems"])
@pytest.mark.parametrize("levels", [((0.75,), (24,)),
                                    ((0.25, 0.75), (24, 24))])
def test_stage_plans_match(stage, levels):
    want = j_make_stage(stage, (0.0055, 0.04), *levels)
    got = make_stage(stage, (0.0055, 0.04), *levels)
    assert got.name == want.name and got.criterion == want.criterion
    assert got.sampling == want.sampling
    np.testing.assert_array_equal(np.asarray(got.list_quality),
                                  np.asarray(want.list_quality))
    if want.lmbda_schedule is None:
        assert got.lmbda_schedule is None
    else:
        np.testing.assert_array_equal(got.lmbda_schedule,
                                      want.lmbda_schedule)
    assert list(got.lmbda_list) == list(want.lmbda_list)
    assert (got.rems is None) == (want.rems is None)
    if want.rems is not None:
        assert list(got.rems) == list(want.rems)


@pytest.fixture(scope="module")
def rem_names():
    jmodel, params, model = tiny_pair("rem")
    return params, [n for n, _ in model.named_parameters()]


def mask_names(mask, params):
    """{port parameter name: bool} of a JAX boolean mask over params."""
    shapes = dict(_flat(params))
    return {_convert_leaf(path, torch.zeros(shapes[path].shape))[0]:
            bool(m) for path, m in _flat(mask)}


@pytest.mark.parametrize("stage,lrp", [("first_train", False),
                                       ("refine_gs", False),
                                       ("refine_gs", True),
                                       ("refine_gs_ga", False),
                                       ("rems", False)])
def test_trainable_masks_match(rem_names, stage, lrp):
    params, names = rem_names
    want = mask_names(j_trainable_mask(params, stage, lrp), params)
    got = trainable_mask(names, stage, lrp)
    assert got == want
    assert any(got.values())
    qwant = mask_names(j_quantiles_mask(params), params)
    assert quantiles_mask(names) == qwant
    assert {n for n, t in qwant.items() if t} == \
        {"entropy_bottleneck.quantiles"}


# ---- the optimizers against optax on a small tree ----

class Small(torch.nn.Module):
    """Parameters named as the model's: two trainable groups in
    refine_gs_ga, one frozen, and the quantiles."""

    multiple_encoder = multiple_decoder = True  # branch-suffixed names

    def __init__(self, tree):
        super().__init__()
        for group, leaves in tree.items():
            mod = torch.nn.Module()
            for k, v in leaves.items():
                mod.register_parameter(k, torch.nn.Parameter(
                    torch.from_numpy(np.array(v))))
            self.add_module(group, mod)


def _small_tree(rng):
    return {"g_s_1": {"w": rng.normal(0, 1, (4, 3)).astype(np.float32)},
            "g_a_1": {"w": rng.normal(0, 1, (5,)).astype(np.float32)},
            "h_a": {"w": rng.normal(0, 1, (6,)).astype(np.float32)},
            "entropy_bottleneck": {
                "quantiles": rng.normal(0, 1, (2, 1, 3)).astype(np.float32)}}


def _grads(rng, tree, scale):
    return jax.tree.map(lambda a: (scale * rng.normal(0, 1, a.shape))
                        .astype(np.float32), tree)


def _same(state, jstate, rtol=1e-6):
    got = dict(state.model.named_parameters())
    for name, want in port_names(jstate.params).items():
        np.testing.assert_allclose(got[name].detach().numpy(), want.numpy(),
                                   rtol=rtol, atol=1e-7, err_msg=name)


def test_optimizers_match_optax():
    """Five main and aux steps, norms above and below the clip, then a
    learning-rate change: parameters and moments as optax gives them;
    h_a (frozen in refine_gs_ga) bitwise unchanged and without state."""
    rng = np.random.default_rng(0)
    tree = _small_tree(rng)
    model = Small(tree)
    h_a = model.h_a.w.detach().clone()
    state = TrainState(model, "refine_gs_ga")
    jstate = j_create_train_state(jax.tree.map(jnp.asarray, tree),
                                  "refine_gs_ga")
    assert state.trainable_names == ["g_s_1.w", "g_a_1.w"]
    assert state.aux_names == ["entropy_bottleneck.quantiles"]
    for k, scale in enumerate((3.0, 0.05, 2.0, 0.01, 1.0)):
        if k == 3:
            jstate = j_set_lr(jstate, 3e-5)
            set_learning_rate(state, 3e-5)
            assert get_learning_rate(state) == 3e-5
            np.testing.assert_allclose(j_get_lr(jstate), 3e-5, rtol=1e-6)
        g = _grads(rng, tree, scale)
        pg = port_names(g)
        info = state.apply_main([pg[n] for n in state.names])
        jstate = jstate.apply_main(jax.tree.map(jnp.asarray, g))
        norm = float(optax.global_norm(g))
        np.testing.assert_allclose(info["grad_norm"], norm, rtol=1e-6)
        assert info["clip_scale"] == (1.0 if norm < 1.0 else
                                      pytest.approx(1.0 / norm, rel=1e-6))
        ag = _grads(rng, tree, scale)
        state.apply_aux([torch.from_numpy(
            ag["entropy_bottleneck"]["quantiles"])])
        jstate = jstate.apply_aux(jax.tree.map(jnp.asarray, ag))
        _same(state, jstate)
    mu, nu = (port_names(t) for t in adam_moments(jstate.opt_state))
    assert set(mu) == {"g_s_1.w", "g_a_1.w"}
    for name, m, v in zip(state.trainable_names, state.main.mu,
                          state.main.nu):
        np.testing.assert_allclose(m.numpy(), mu[name].numpy(), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(v.numpy(), nu[name].numpy(), rtol=1e-6,
                                   atol=1e-12)
    assert torch.equal(model.h_a.w, h_a)
    assert state.main.count == 5 and state.step == 5


def test_non_finite_gradient_is_skipped_then_training_proceeds():
    """A non-finite gradient anywhere (here a frozen parameter's) skips the
    whole update: parameters and moments untouched, Adam's count not
    advanced; the next finite step applies; after 20 consecutive
    non-finite steps the 21st is applied, as optax.apply_if_finite does.
    The aux optimizer is guarded the same way."""
    rng = np.random.default_rng(1)
    tree = _small_tree(rng)
    model = Small(tree)
    state = TrainState(model, "refine_gs_ga")
    jstate = j_create_train_state(jax.tree.map(jnp.asarray, tree),
                                  "refine_gs_ga")
    g = _grads(rng, tree, 0.5)
    pg = port_names(g)
    tg = [pg[n] for n in state.names]
    state.apply_main(tg)
    jstate = jstate.apply_main(jax.tree.map(jnp.asarray, g))
    before = [p.detach().clone() for p in state.params]
    moments = [m.clone() for m in state.main.mu + state.main.nu]
    bad = [t.clone() for t in tg]
    bad[state.names.index("h_a.w")][2] = float("nan")
    info = state.apply_main(bad)
    assert not info["finite"] and not info["applied"]
    assert all(torch.equal(p, b) for p, b in zip(state.params, before))
    assert all(torch.equal(m, b) for m, b in
               zip(state.main.mu + state.main.nu, moments))
    assert state.main.count == 1 and state.main_guard.notfinite_count == 1
    jbad = jax.tree.map(jnp.asarray, g)
    jbad["h_a"]["w"] = jbad["h_a"]["w"].at[2].set(jnp.nan)
    jstate = jstate.apply_main(jbad)
    _same(state, jstate)
    info = state.apply_main(tg)
    jstate = jstate.apply_main(jax.tree.map(jnp.asarray, g))
    assert info["applied"] and state.main.count == 2
    _same(state, jstate)
    assert state.main_guard.notfinite_count == 0
    for k in range(21):
        info = state.apply_main(bad)
        assert info["applied"] == (k == 20)
    assert not torch.isfinite(model.g_a_1.w).all()
    q = model.entropy_bottleneck.quantiles.detach().clone()
    assert not state.apply_aux([torch.full_like(q, float("inf"))])
    assert torch.equal(model.entropy_bottleneck.quantiles, q)


# ---- full steps of the tiny model against the JAX package ----

@pytest.fixture(scope="module")
def pic():
    return tiny_pair("pic")


def test_first_train_step_matches_jax(pic, record_property):
    """The multi-quality forward ([0, 10]: x_hat [2, B, ...], likelihoods
    y / y_prog / z) and the four criteria on it, then the step."""
    jmodel, params, _ = pic
    model = port_model("pic", params)
    x = batch()
    jres, = jax_steps(jmodel, params, [("first_train", None)], x)
    pres = port_step(model, "first_train", x)
    check_forward(jres[3], pres[3], x, (0.0055, 0.04))
    check_step(jres, pres, record_property)
