"""One full step of the refine_gs and refine_gs_ga stages on the tiny
``pic`` model against the JAX package (float32, ``training=False``), from
the same weights, batch and sampled quality: the single-quality forward
and the four criteria on it, the loss, the gradients before the clip, the
clip scale, the parameters and the moments after the step, at the
tolerances of test_torch_train_step.py (``check_forward``,
``check_step``). The two JAX steps share one program (the forward runs
once). Only the parameters each stage trains change, and the quantiles
(the aux optimizer's); every other one comes out bitwise as it went in.
"""

import pytest
import torch

from epic_tpu_torch.training.stages import make_stage
from test_torch_train_step import (batch, check_forward, check_step,
                                   jax_steps, port_model, port_step,
                                   tiny_pair)
from test_torch_train_step import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def refine():
    jmodel, params, _ = tiny_pair("pic", seed=7)
    plan = make_stage("refine_gs_ga")
    qi = 150
    q = plan.list_quality[qi]
    lmbdas = {"refine_gs": float(make_stage("refine_gs").lmbda_list[-1]),
              "refine_gs_ga": float(plan.lmbda_schedule[qi])}
    x = batch(3)
    jres = jax_steps(jmodel, params, list(lmbdas.items()), x, q)
    return params, x, q, lmbdas, dict(zip(lmbdas, jres))


@pytest.mark.parametrize("stage,trained", [
    ("refine_gs", {"g_s_1"}),
    ("refine_gs_ga", {"g_s_1", "g_a_1"})])
def test_refine_step_matches_jax(refine, stage, trained, record_property):
    params, x, q, lmbdas, jres = refine
    model = port_model("pic", params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pres = port_step(model, stage, x, q, lmbdas[stage])
    check_forward(jres[stage][3], pres[3], x, lmbdas[stage])
    check_step(jres[stage], pres, record_property)
    changed = {k.split(".")[0] for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
    assert changed == trained | {"entropy_bottleneck"}
    assert {k for k, v in model.state_dict().items()
            if k.startswith("entropy_bottleneck")
            and not torch.equal(v, before[k])} == \
        {"entropy_bottleneck.quantiles"}
