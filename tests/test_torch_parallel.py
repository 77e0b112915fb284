"""The port's data-parallel layer (``epic_tpu_torch.parallel``) and its
multi-process RD sweep, on the CPU over gloo.

Four ranks (processes of ``tests/torch_parallel_worker.py``, one torch
thread each, started once for the file) each take one row of a global batch
of 4 tiny 64x64 images:

- first_train and rems steps (``training=False``, 2 steps each; rems
  conditioned on the ranks' checkpoint latents) match the single-process
  ``TrainStep`` on the global batch: the losses within 1e-5 relative, and
  every parameter tensor after the steps within 1e-5 of its largest
  magnitude (float32 sums over shards in another order);
- a noisy first_train step (each rank its own generator) leaves every
  rank's parameters bitwise equal;
- the eval step's bits per pixel within 1e-5 relative of the single
  process's, and each rank's mse within 1e-5 relative of its rows'.

Besides: ``local_shard`` equals the JAX package's; ``shard_batch`` refuses
a batch that does not divide; ``init_multihost`` is a no-op for one
process and needs an explicit backend; the RD sweep tool at 2 processes
prints the rows of 1 process bitwise, and at 1 process its bpp are
``progressive_encode``'s bits.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from epic_tpu.parallel import local_shard as j_local_shard
from epic_tpu_torch import PICCodec, get_model, progressive_encode
from epic_tpu_torch.parallel import (init_multihost, local_shard, make_mesh,
                                     shard_batch)
from epic_tpu_torch.tools import multihost_rd_sweep as sweep
from test_torch_train_step import one_torch_thread  # noqa: F401
import torch_parallel_worker as worker

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable] + args, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(procs):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks and the 2-process sweep, started together; while
    they run, the single-process references and the 1-process sweep."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    port, sweep_port = _free_port(), _free_port()
    ranks = [_start([os.path.join(REPO, "tests", "torch_parallel_worker.py"),
                     str(r), str(WORLD), str(port), out_dir])
             for r in range(WORLD)]
    pair = [_start(["-m", "epic_tpu_torch.tools.multihost_rd_sweep",
                    "--device", "cpu", "--num_processes", "2",
                    "--process_id", str(r), "--coordinator",
                    f"localhost:{sweep_port}"]) for r in range(2)]
    ref = worker.run(None)
    single = sweep.main(["--device", "cpu"])
    _wait(ranks)
    lines = [line for line in _wait(pair)[0].splitlines()
             if line.startswith("RDSWEEP ")]
    assert len(lines) == 1
    return {"ref": ref, "single": single,
            "pair": json.loads(lines[0][len("RDSWEEP "):]),
            "ranks": [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                      for r in range(WORLD)]}


def _params_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("stage", ["first_train", "rems"])
def test_parallel_step_matches_single_process(runs, stage):
    ref = runs["ref"]
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_allclose(res[f"{stage}_loss"], ref[f"{stage}_loss"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        _params_close(res[f"{stage}_params"], ref[f"{stage}_params"])
    if stage == "rems":
        # each rank's checkpoint latent is its row of the global one
        ck = np.concatenate([res["rems_ckpt"] for res in runs["ranks"]])
        np.testing.assert_allclose(ck, ref["rems_ckpt"], rtol=0, atol=1e-5)


def test_noise_step_keeps_ranks_equal(runs):
    digests = {str(res["noise_params_sha256"]) for res in runs["ranks"]}
    assert len(digests) == 1


def test_eval_step_matches_single_process(runs):
    ref = runs["ref"]
    mse = np.concatenate([res["eval_mse"] for res in runs["ranks"]])
    np.testing.assert_allclose(mse, ref["eval_mse"], rtol=1e-5)
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["eval_bpp"], ref["eval_bpp"],
                                   rtol=1e-5)


@pytest.mark.parametrize("n,count", [(10, 3), (4, 2), (4, 4), (3, 4),
                                     (7, 1), (0, 2)])
def test_local_shard_matches_jax(n, count):
    items = list(range(n))
    shards = [local_shard(items, i, count) for i in range(count)]
    assert shards == [j_local_shard(items, process_index=i,
                                    process_count=count)
                      for i in range(count)]
    assert sum(shards, []) == items


def test_shard_batch_and_group_arguments():
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, None)
    x = torch.zeros(3, 4)
    assert torch.equal(shard_batch(x, mesh), x)
    uneven = type(mesh)(0, 2, mesh.device, "gloo")
    with pytest.raises(ValueError, match="divide"):
        shard_batch(x, uneven)
    assert init_multihost() is False
    with pytest.raises(ValueError, match="backend"):
        init_multihost("localhost:1", 2, 0)


def test_rd_sweep_two_processes_equal_one(runs):
    single, pair = runs["single"], runs["pair"]
    assert (single["processes"], pair["processes"]) == (1, 2)
    assert pair["n_images"] == single["n_images"] == 4
    assert pair["rows"] == single["rows"]


def test_rd_sweep_bpp_is_progressive_encode_bits(runs):
    """At one process each row's bpp are the cumulative bits of
    ``progressive_encode`` of that image over its pixels."""
    model = get_model("pic", **sweep.TINY).init_weights(sweep.SEED)
    codec = PICCodec(model, device="cpu")
    for row in runs["single"]["rows"]:
        i = int(row[0])
        x = sweep.synth_image(i)[None]
        _, bits = progressive_encode(codec, x, sweep.Q_LIST)
        bpp = np.cumsum([bits[0] + bits[1]] + list(bits[2])) / (64 * 64)
        want = np.float32([round(float(b), 6) for b in bpp])
        got = np.float32(row[1:2 + len(sweep.Q_LIST)])
        np.testing.assert_array_equal(got, want)
