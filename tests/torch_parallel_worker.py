"""One rank of the data-parallel checks of test_torch_parallel.py (not a
test module): joins a gloo group of CPU ranks, runs the parallel steps on
its rows of the global batch and writes what it computed to
``OUT/rank{r}.npz``. ``run(None)`` computes the same things in one process
with the port's single-process ``TrainStep`` and eval step, on the whole
batch: the reference.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT
"""

import hashlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from epic_tpu_torch import get_model  # noqa: E402
from epic_tpu_torch.parallel import (init_multihost, make_mesh,  # noqa: E402
                                     make_parallel_ckpt_extractor,
                                     make_parallel_eval_step,
                                     make_parallel_train_step, rank_generator,
                                     replicate, shard_batch)
from epic_tpu_torch.training.stages import make_stage  # noqa: E402
from epic_tpu_torch.training.state import TrainState  # noqa: E402
from epic_tpu_torch.training.step import (TrainStep,  # noqa: E402
                                          extract_quality_ref,
                                          make_ckpt_extractor,
                                          make_eval_step)

TINY = dict(n=16, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))
CHECK_LEVELS = (0.25, 0.75)
GLOBAL_BATCH, STEPS, QUALITY, LMBDA, NOISE_SEED = 4, 2, 0.5, 0.04, 7


def global_batch() -> np.ndarray:
    return np.random.default_rng(0).random((GLOBAL_BATCH, 64, 64, 3),
                                           dtype=np.float32)


def _model(name: str):
    extra = dict(check_levels=CHECK_LEVELS, rem_dimension="middle") \
        if name == "rem" else {}
    return get_model(name, **TINY, **extra).init_weights(3)


def _flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]) \
        .numpy()


def run(mesh) -> dict:
    """The checks' values: with a mesh, the parallel steps on the rank's
    rows; with None, the single-process steps on the global batch."""
    x = torch.from_numpy(global_batch())
    if mesh is not None:
        x = shard_batch(x, mesh)
    out = {}
    for stage in ("first_train", "rems"):
        model = _model("pic" if stage == "first_train" else "rem")
        plan = make_stage(stage, check_levels=CHECK_LEVELS,
                          check_levels_np=(4, 4))
        state = TrainState(model, stage)
        if mesh is None:
            step = TrainStep(model, plan, training=False)
            extract = make_ckpt_extractor(model, CHECK_LEVELS)
            ck = extract(x, QUALITY) if plan.sampling else None
        else:
            replicate(state, mesh)
            step = make_parallel_train_step(model, plan, mesh,
                                            training=False)
            ck = make_parallel_ckpt_extractor(model, mesh)(
                x, extract_quality_ref(QUALITY, CHECK_LEVELS)) \
                if plan.sampling else None
        args = (None, QUALITY, LMBDA, ck) if plan.sampling else ()
        out[f"{stage}_loss"] = np.array(
            [float(step(state, x, *args)["loss"]) for _ in range(STEPS)])
        out[f"{stage}_params"] = _flat_params(model)
        if ck is not None:
            out[f"{stage}_ckpt"] = ck.numpy()
    # the eval step on the rems model after its steps
    evaluate = (make_eval_step(model) if mesh is None
                else make_parallel_eval_step(model, mesh))
    _, bpp, mse = evaluate(x, QUALITY)
    out["eval_bpp"], out["eval_mse"] = np.float32(bpp), mse.numpy()
    if mesh is not None:
        # one noisy step from the replicated weights: each rank's own noise
        model = _model("pic")
        state = replicate(TrainState(model), mesh)
        make_parallel_train_step(model, make_stage("first_train"), mesh)(
            state, x, rank_generator(mesh, NOISE_SEED))
        out["noise_params_sha256"] = np.array(hashlib.sha256(
            _flat_params(model).tobytes()).hexdigest())
    return out


if __name__ == "__main__":
    rank, world, port, out_dir = sys.argv[1:5]
    torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", int(world), int(rank), "gloo")
    res = run(make_mesh("cpu"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
