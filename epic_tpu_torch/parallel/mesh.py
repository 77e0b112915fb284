"""Data parallelism over a process group: the parameters are replicated,
the global batch is sharded on axis 0, one rank per device.

- ``make_mesh`` describes the group: this process's rank, the world size
  and the rank's device (CUDA ranks with "nccl", one GPU each; CPU ranks
  with "gloo"). Outside a process group it is a group of one.
- ``replicate`` broadcasts the parameters and the optimizer state from
  rank 0; ``shard_batch`` gives the rank its rows of the global batch.
- ``make_parallel_train_step`` wraps the port's ``TrainStep``. Each rank
  computes the loss and the gradients of its rows; the gradients and the
  metrics are averaged across ranks by one float32 all-reduce over a flat
  buffer per step (not one per parameter; in a group of one too); then
  every rank applies the same update, and the finite guard decides from
  the averaged gradients, so all ranks agree. A single-quality criterion
  weights the hyperprior rate by the batch size, here the global one. The
  aux loss (the bottleneck's quantile fit) does not see the batch: its
  gradients, taken at the updated parameters as in ``TrainStep``, are
  the same on every rank, so they need no collective.
  The all-reduce is written by hand: ``DistributedDataParallel`` arms its
  hooks in its own ``forward``, and the step calls ``multi_quality`` or
  ``forward_single_quality``.
- ``make_parallel_ckpt_extractor``: a rank's rows in, their checkpoint
  latent out (REM training).
- ``make_parallel_eval_step``: x_hat and the per-image mse of the rank's
  rows; the bits summed across ranks over the global B*H*W.

Training noise: each rank draws from its own ``torch.Generator``, seeded
from (seed, rank) (``rank_generator``). The JAX package draws one global
noise and shards it; the port's noise differs from JAX's draws anyway.
With ``training=False`` (rounding, no noise) a step of W ranks computes
what ``TrainStep`` computes on the global batch, up to float32 summation
order; with one rank, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..training.stages import StagePlan
from ..training.state import TrainState
from ..training.step import TrainStep


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    device: torch.device
    backend: str | None  # None outside a process group


def make_mesh(device=None) -> Mesh:
    """The process group as a 1-D data mesh. ``device`` as the entry
    points take it (``cuda`` unless "cpu"); a CUDA rank of an "nccl" group
    gets GPU ``rank % device_count()`` and makes it current. An "nccl"
    group needs CUDA ranks and a "gloo" group CPU ranks."""
    initialized = dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    world = dist.get_world_size() if initialized else 1
    backend = dist.get_backend() if initialized else None
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend not in (None, "nccl"):
            raise ValueError(f"CUDA ranks need the nccl backend, not "
                             f"{backend!r}")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend not in (None, "gloo"):
        raise ValueError(f"CPU ranks need the gloo backend, not {backend!r}")
    return Mesh(rank, world, dev, backend)


def _broadcast(tensors, mesh: Mesh) -> None:
    if mesh.world > 1:
        for t in tensors:
            dist.broadcast(t, src=0)


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Rank 0's values on every rank, in place, and ``obj`` returned: a
    module's state_dict, or a ``TrainState``'s model with both optimizers'
    moments and step counts. The model must be on the rank's device
    already (a ``TrainState`` keeps its moments where the parameters
    were)."""
    model = obj.model if isinstance(obj, TrainState) else obj
    if any(t.device != mesh.device for t in model.state_dict().values()):
        raise ValueError(f"the model is not on the rank's device "
                         f"{mesh.device}")
    _broadcast(model.state_dict().values(), mesh)
    if isinstance(obj, TrainState):
        for opt in (obj.main, obj.aux):
            _broadcast(opt.mu + opt.nu, mesh)
            count = torch.tensor([opt.count], device=mesh.device)
            _broadcast([count], mesh)
            opt.count = int(count)
    return obj


def shard_batch(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of the global batch [B, ...], on its
    device. B must divide by the world size."""
    batch = torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch)
                            else batch)
    b = batch.shape[0]
    if b % mesh.world:
        raise ValueError(f"a global batch of {b} does not divide over "
                         f"{mesh.world} ranks")
    per = b // mesh.world
    return batch[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def rank_generator(mesh: Mesh, seed: int) -> torch.Generator:
    """The rank's noise generator on its device, seeded from (seed,
    rank)."""
    return torch.Generator(device=mesh.device).manual_seed(
        int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0]))


class ParallelTrainStep:
    """``step(state, local_batch, generator, quality, lmbda,
    checkpoint_ref) -> metrics`` (averaged across ranks), as
    ``TrainStep.__call__`` on the rank's rows; ``checkpoint_ref`` is the
    rank's rows' latent. Each call makes one all-reduce."""

    def __init__(self, model, plan: StagePlan, mesh: Mesh,
                 training: bool = True):
        self.model, self.mesh = model, mesh
        self.step = TrainStep(model, plan, training)

    def __call__(self, state: TrainState, batch: torch.Tensor,
                 generator=None, quality=None, lmbda=None,
                 checkpoint_ref=None) -> Dict[str, torch.Tensor]:
        # a single-quality criterion weights the hyperprior rate by the
        # batch size: the global one here, as TrainStep on the global batch
        hyper_weight = (batch.shape[0] * self.mesh.world
                        if self.step.plan.sampling else None)
        metrics = self.step.loss(batch, generator, quality, lmbda,
                                 checkpoint_ref, hyper_weight)
        grads = TrainStep.gradients(state, metrics["loss"])
        keys = list(metrics)
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [metrics[k].detach().float().reshape(-1)
                            for k in keys])
        if self.mesh.backend is not None:
            dist.all_reduce(flat)
            if self.mesh.world > 1:
                flat /= self.mesh.world
        # back into the gradients' own tensors: the update then reads them
        # with the layout and alignment a single process would
        pos = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[pos:pos + g.numel()].view(g.shape))
                pos += g.numel()
        info = state.apply_main(grads)
        aux_grads = torch.autograd.grad(self.model.aux_loss(),
                                        state.aux_params)
        state.apply_aux(aux_grads)
        out = {}
        for k in keys:
            m = metrics[k]
            out[k] = flat[pos:pos + m.numel()].view(m.shape).to(m.dtype)
            pos += m.numel()
        with torch.no_grad():
            out["aux_loss"] = self.model.aux_loss()
        out["grad_norm"] = torch.tensor(info["grad_norm"])
        return out


def make_parallel_train_step(model, plan: StagePlan, mesh: Mesh,
                             training: bool = True) -> ParallelTrainStep:
    """The data-parallel ``TrainStep`` of a stage: the multi-quality
    stages and the sampling ones, with a checkpoint latent for rems."""
    return ParallelTrainStep(model, plan, mesh, training)


def make_parallel_ckpt_extractor(model, mesh: Mesh) -> Callable:
    """extract(local_batch, quality_ref) -> the rank's rows' decoded latent
    at the checkpoint quality (deterministic forward, no gradient): the
    checkpoint latent of REM training, sharded as the batch is."""
    @torch.no_grad()
    def extract(batch: torch.Tensor, quality_ref: float) -> torch.Tensor:
        return model.forward_single_quality(batch, quality_ref,
                                            False)["y_hat"]

    return extract


def make_parallel_eval_step(model, mesh: Mesh) -> Callable:
    """evaluate(local_batch, quality) -> (x_hat of the rank's rows, bits
    per pixel of the global batch estimated from the likelihoods, the
    rows' mse [b]). The bits are summed across ranks (one all-reduce) and
    divided by the global B*H*W."""
    @torch.no_grad()
    def evaluate(batch: torch.Tensor, quality: float):
        out = model.forward_single_quality(batch, quality, False)
        b, h, w, _ = batch.shape
        bits = sum(-torch.log2(lik).sum()
                   for lik in out["likelihoods"].values()).reshape(1)
        if mesh.backend is not None:
            dist.all_reduce(bits)
        mse = ((out["x_hat"] - batch) ** 2).mean(dim=(1, 2, 3))
        return out["x_hat"], bits[0] / (b * mesh.world * h * w), mse

    return evaluate
