"""Whether first_train's loss on one fixed batch moves the same way without
the GDN kernels: a witness at flagship width.

first_train (``tools/workload.py``'s ``pic`` configuration, random weights
from seed 0) takes 6 steps on one fixed batch of ``bench.py``'s synthetic
images (batch 16, patch 256, ``train_device``'s defaults), with the same
noise generator seed, in four runs that each differ from the first in one
thing:

- ``kernels``: bf16 compute, GDN / IGDN through the hand-written forward
  and backward kernels (the trainer's path);
- ``plain``: bf16, GDN / IGDN through autograd of ``gdn_plain`` (no
  kernel launches);
- ``float32``: the kernels, float32 compute;
- ``lr/10``: the kernels, learning rate 1e-5 instead of 1e-4.

Per step it prints the loss and its terms (rates, the MSE of each level)
and the gradient norm before the clip; per run the kernel launches; and
how far ``plain``'s first-step gradients are from ``kernels``' (relative
L2 distance over all gradients, and the largest over single tensors).
Needs one CUDA device.

    python3 -m epic_tpu_torch.tools.train_witness

``fixture_steps`` runs the steps that ``tests/fixtures/first_train_jax.json``
records for the JAX trainer (written by ``tests/gen_torch_train_fixture.py``):
first_train in float32 with ``training=False`` (rounding, no noise) at lr
1e-4, on ``utils.synthetic.synth_batch`` and the ``pic`` flagship weights of
``init_weights(0)``, whose SHA-256 (``weights_sha256``, ``batch_sha256``)
the fixture also holds.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

from ..data.device_bank import build_crop_bank, make_device_sampler
from ..device import resolve_device
from ..models import get_model
from ..ops import gdn as gdn_module
from ..ops.gdn_kernel import gdn, gdn_backward, gdn_plain
from ..training.stages import make_stage
from ..training.state import TrainState, set_learning_rate
from ..training.step import TrainStep, make_train_step
from ..utils.synthetic import synth_images
from .profile_train import stage_runner
from .workload import PIC

STEPS, BATCH, PATCH = 6, 16, 256
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "first_train_jax.json")
# name: (compute dtype, GDN through the kernels, learning rate)
RUNS = {"kernels": ("bfloat16", True, 1e-4),
        "plain": ("bfloat16", False, 1e-4),
        "float32": ("float32", True, 1e-4),
        "lr/10": ("bfloat16", True, 1e-5)}


@contextlib.contextmanager
def _gdn_route(kernels: bool):
    """GDN layers through the kernels, or through autograd of
    ``gdn_plain``."""
    saved = gdn_module.gdn_differentiable
    if not kernels:
        gdn_module.gdn_differentiable = gdn_plain
    try:
        yield
    finally:
        gdn_module.gdn_differentiable = saved


def _terms(m) -> dict:
    return {"loss": float(m["loss"]), "bpp_base": float(m["bpp_base"]),
            "bpp_scalable": float(m["bpp_scalable"]),
            "bpp_hype": float(m["bpp_hype"]),
            "mse": [float(v) for v in m["mse_loss"]],
            "grad_norm": float(m["grad_norm"])}


def sha256_arrays(arrays) -> str:
    """SHA-256 of float32 arrays' bytes, one after another."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=np.float32).tobytes())
    return h.hexdigest()


def weights_sha256(model) -> str:
    """SHA-256 of a model's state_dict in float32, keys in sorted order."""
    sd = model.state_dict()
    return sha256_arrays(sd[k].detach().float().cpu().numpy()
                         for k in sorted(sd))


def batch_sha256(batch) -> str:
    return sha256_arrays([np.asarray(batch)])


def fixture_steps(model, batch: torch.Tensor, steps: int = STEPS,
                  lr: float = 1e-4) -> list:
    """first_train steps on one fixed batch with ``training=False`` (the
    function the fixture's JAX steps compute): per step
    ``{"loss", "bpp_loss", "bpp_base", "bpp_scalable", "bpp_hype", "mse",
    "qualities"}`` (the terms at the parameters before the step)."""
    plan = make_stage("first_train")
    state = TrainState(model, "first_train", lr)
    step = make_train_step(model, plan, training=False)
    rows = []
    for _ in range(steps):
        m = step(state, batch)
        rows.append({k: float(m[k]) for k in (
            "loss", "bpp_loss", "bpp_base", "bpp_scalable", "bpp_hype")})
        rows[-1]["mse"] = [float(v) for v in m["mse_loss"]]
        rows[-1]["qualities"] = [float(q) for q in plan.list_quality]
    return rows


def witness(name: str, batch, dev):
    """One run: (per-step terms, launches, first-step gradients)."""
    dtype, kernels, lr = RUNS[name]
    model = get_model("pic", **dict(PIC, compute_dtype=dtype)).init_weights(
        0).to(dev)
    with _gdn_route(kernels):
        run, state = stage_runner(model, "first_train", lambda _: batch, dev)
        set_learning_rate(state, lr)
        # the first step's gradients, with the noise the run's first step
        # draws (stage_runner seeds its generator with 0)
        loss = make_train_step(model, make_stage("first_train")).loss(
            batch, torch.Generator(device=dev).manual_seed(0))["loss"]
        grads = TrainStep.gradients(state, loss)
        del loss
        torch.cuda.synchronize()
        gdn.launches.update(gdn=0, igdn=0)
        gdn_backward.launches.update(gdn=0, igdn=0)
        rows = []
        for i in range(STEPS):
            rows.append(_terms(run()))
            r = rows[-1]
            print(f"[{name}] step {i}: loss {r['loss']:.4f} (bpp base "
                  f"{r['bpp_base']:.4f} scalable {r['bpp_scalable']:.4f} "
                  f"hype {r['bpp_hype']:.4f}; mse "
                  + "/".join(f"{v:.5f}" for v in r["mse"])
                  + f"); grad norm {r['grad_norm']:.4e}", flush=True)
        torch.cuda.synchronize()
    launches = {"forward": dict(gdn.launches),
                "backward": dict(gdn_backward.launches)}
    print(f"[{name}] GDN launches over the steps: {launches}", flush=True)
    return rows, launches, grads


def main() -> None:
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[train_witness] {smi}; first_train, batch {BATCH} x "
          f"{PATCH}^2, {STEPS} steps on one fixed batch", flush=True)
    imgs = synth_images(8, np.random.default_rng(0))
    batch = make_device_sampler(build_crop_bank(imgs, None, PATCH), PATCH,
                                BATCH, dev)(
        torch.Generator(device=dev).manual_seed(5))
    out, ref = {}, None
    for name in RUNS:
        rows, launches, grads = witness(name, batch, dev)
        out[name] = {"steps": rows, "launches": launches}
        if name == "kernels":
            ref = grads
        elif name == "plain":
            diff = torch.sqrt(sum(((a - b) ** 2).sum()
                                  for a, b in zip(grads, ref)))
            norm = torch.sqrt(sum((b ** 2).sum() for b in ref))
            worst = max(float((a - b).norm() / b.norm())
                        for a, b in zip(grads, ref) if b.norm() > 0)
            out["plain_vs_kernels_grads"] = {
                "rel_l2": float(diff / norm), "max_tensor_rel_l2": worst}
            print(f"[plain vs kernels] first-step gradients: relative L2 "
                  f"{float(diff / norm):.3e}, largest over one tensor "
                  f"{worst:.3e}", flush=True)
        del grads
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
