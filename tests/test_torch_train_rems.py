"""REM training and checkpoints against the JAX package, on the CPU.

- One full step of the rems stage on the tiny ``rem`` model (float32,
  ``training=False``), conditioned on the checkpoint latent from the
  port's extractor (a single-quality forward's y_hat, which
  test_torch_train_refine.py holds to the JAX package), fed to both
  packages: the forward and the four criteria, loss, gradients, clip
  scale, parameters and moments at the tolerances of
  test_torch_train_step.py. Only the REM bank of the sampled quality's
  bracket changes, and the quantiles.
- Checkpoints: one the port writes loads in the JAX package's
  ``load_checkpoint`` to the same arrays bitwise, and one the JAX package
  writes (``save_artifact``, float32) loads in the port to the arrays the
  JAX package reads from it; ``merge_params`` lays a parent over fresh
  REM banks as the JAX package's does.
"""

import json

import numpy as np
import pytest
import torch
import jax

from epic_tpu.training import load_checkpoint as j_load_checkpoint
from epic_tpu.training import merge_params as j_merge_params
from epic_tpu.training.checkpoint import save_artifact as j_save_artifact
from epic_tpu_torch import from_jax_params, load_checkpoint
from epic_tpu_torch.convert import to_jax_params
from epic_tpu_torch.training.checkpoint import merge_params, save_checkpoint
from epic_tpu_torch.training.stages import make_stage
from epic_tpu_torch.training.step import (extract_quality_ref,
                                          make_ckpt_extractor)
from test_torch_train_step import (CHECK_LEVELS, CHECK_LEVELS_NP, TINY_REM,
                                   _flat, batch, check_forward, check_step,
                                   jax_steps, port_model, port_step,
                                   tiny_pair)
from test_torch_train_step import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rem():
    return tiny_pair("rem", seed=6)


def test_rems_step_matches_jax(rem, record_property):
    """A quality above the last check level: bank 1 refines, conditioned on
    the checkpoint latent at 0.75."""
    jmodel, params, _ = rem
    model = port_model("rem", params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    plan = make_stage("rems", check_levels=CHECK_LEVELS,
                      check_levels_np=CHECK_LEVELS_NP)
    q = [v for v in plan.list_quality if v > CHECK_LEVELS[-1]][1]
    qref = extract_quality_ref(q, plan.rems)
    assert qref == CHECK_LEVELS[-1]
    x = batch(4)
    ckpt = make_ckpt_extractor(model, plan.rems)(torch.from_numpy(x),
                                                 q).numpy()
    jres, = jax_steps(jmodel, params, [("rems", None)], x, q, ckpt)
    pres = port_step(model, "rems", x, q, None, ckpt)
    check_forward(jres[3], pres[3], x, 0.04)
    check_step(jres, pres, record_property)
    changed = {k.split(".")[0] for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
    assert changed == {"post_latent_1", "entropy_bottleneck"}


def test_port_checkpoint_loads_in_both_packages(rem, tmp_path):
    jmodel, params, model = rem
    cfg = dict(TINY_REM, model="rem")
    save_checkpoint(str(tmp_path), model, cfg, step=3, is_best=True)
    assert {p.name for p in tmp_path.iterdir()} == {"config.json",
                                                   "last.npz", "best.npz"}
    jm, jparams, jcfg, step = j_load_checkpoint(str(tmp_path))
    assert step == 3 and jcfg["model"] == "rem"
    assert type(jm).__name__ == "VarianceMaskingPICREM"
    want, got = dict(_flat(params)), dict(_flat(jparams))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    back, bcfg, bstep = load_checkpoint(str(tmp_path))
    assert bstep == 3 and bcfg == json.loads(json.dumps(cfg))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_jax_checkpoint_loads_in_port(rem, tmp_path):
    _, params, _ = rem
    j_save_artifact(str(tmp_path), params, dict(TINY_REM, model="rem"),
                    step=5, dtype="float32")
    _, jparams, _, _ = j_load_checkpoint(str(tmp_path))
    model, cfg, step = load_checkpoint(str(tmp_path))
    assert step == 5 and cfg["model"] == "rem"
    want = from_jax_params(jax.tree.map(np.asarray, jparams), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    flat = dict(_flat(to_jax_params(model)))
    for k, v in _flat(jparams):
        np.testing.assert_array_equal(flat[k], np.asarray(v))


def test_merge_params_matches_jax(rem):
    """A trained pic's weights over a fresh rem model: the REM banks stay
    fresh, everything else comes from the parent, in both packages."""
    _, fresh_params, fresh = rem
    jpic, pic_params, pic = tiny_pair("pic", seed=8)
    want = from_jax_params(j_merge_params(fresh_params, pic_params), fresh)
    got = merge_params(fresh.state_dict(), pic.state_dict())
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        src = fresh if k.startswith("post_latent") else pic
        assert torch.equal(v, src.state_dict()[k]), k
