"""Write the JAX trainer's first_train losses that chip_smoke.py holds the
port's to (``tests/fixtures/first_train_jax.json``).

The port's flagship ``pic`` model (N=192, M=640, division (320, 640),
dim_chunk 32) in float32 with the weights of ``init_weights(0)`` (drawn on
a CPU generator, so every machine gets the same ones) is moved into the
JAX package's model through ``convert.to_jax_params``. Six first_train
steps then run in the JAX package, built from its public pieces
(``CRITERIA``, ``create_train_state``, ``apply_main`` / ``apply_aux``,
``aux_loss``) with ``training=False`` (rounding, no noise) at lr 1e-4, on
one fixed batch of ``utils.synthetic.synth_batch`` (synthetic images,
256x256 crops, drawn with numpy from seed 0). The fixture holds each
step's loss terms (the terms at the parameters before the step) and
qualities, and the SHA-256 of the weights and of the batch. Not collected
by pytest; the port never imports it. Run from the repository's root:

    JAX_PLATFORMS=cpu python tests/gen_torch_train_fixture.py [--batch 4]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import torch

    from epic_tpu.models import get_model as j_get_model
    from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
    from epic_tpu.training import create_train_state, make_stage
    from epic_tpu.training.losses import CRITERIA
    from epic_tpu_torch import get_model
    from epic_tpu_torch.convert import to_jax_params
    from epic_tpu_torch.tools.train_witness import (FIXTURE, PATCH,
                                                    batch_sha256,
                                                    weights_sha256)
    from epic_tpu_torch.tools.workload import PIC
    from epic_tpu_torch.utils.synthetic import synth_batch

    torch.set_num_threads(1)
    cfg = dict(PIC, compute_dtype="float32")
    model = get_model("pic", **cfg).init_weights(0)
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    batch = synth_batch(args.batch, PATCH, seed=0)
    jmodel = j_get_model("pic", **cfg)
    plan = make_stage("first_train")
    crit = CRITERIA[plan.criterion]
    lmbda = jnp.asarray(plan.lmbda_list, jnp.float32)
    qualities = list(plan.list_quality)
    x = jnp.asarray(batch)

    @jax.jit
    def step(state):
        def loss_fn(p):
            out = jmodel.apply({"params": p}, x, qualities, False)
            d = crit(out, x, lmbda)
            return d["loss"], d

        (_, d), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        state = state.apply_main(g)
        ag = jax.grad(lambda p: jmodel.apply(
            {"params": p}, method=JPIC.aux_loss))(state.params)
        return state.apply_aux(ag), d

    state = create_train_state(params, "first_train", 1e-4)
    rows = []
    for i in range(args.steps):
        t = time.time()
        state, d = step(state)
        row = {k: float(d[k]) for k in ("loss", "bpp_loss", "bpp_base",
                                        "bpp_scalable", "bpp_hype")}
        row["mse"] = [float(v) for v in np.asarray(d["mse_loss"])]
        row["qualities"] = [float(q) for q in qualities]
        rows.append(row)
        print(f"step {i}: loss {row['loss']:.4f} mse {row['mse']} "
              f"({time.time() - t:.1f} s)", flush=True)
    out = {"what": "first_train of the JAX package, float32, "
                   "training=False, lr 1e-4, on the port's pic flagship "
                   "weights of init_weights(0) (tests/"
                   "gen_torch_train_fixture.py)",
           "config": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cfg.items()},
           "batch": args.batch, "patch": PATCH, "batch_seed": 0,
           "weights_seed": 0, "lr": 1e-4,
           "weights_sha256": weights_sha256(model),
           "batch_sha256": batch_sha256(batch), "steps": rows}
    if args.batch != 16:
        out["note"] = (f"batch {args.batch}, not the trainer's 16: six JAX "
                       "steps at batch 16 would take more than 30 min on "
                       "the CPU that wrote this")
    path = args.out or FIXTURE
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
