"""Data parallelism and multi-process sweeps over ``torch.distributed``:
parameters replicated, the batch sharded on axis 0, gradients averaged by
one all-reduce per step (``mesh``); process groups joined over ``tcp://``
and work lists sharded by process (``distributed``). The names are the JAX
package's ``parallel``'s."""

from .distributed import init_multihost, local_shard
from .mesh import (Mesh, make_mesh, make_parallel_ckpt_extractor,
                   make_parallel_eval_step, make_parallel_train_step,
                   rank_generator, replicate, shard_batch)

__all__ = [
    "make_mesh",
    "replicate",
    "shard_batch",
    "make_parallel_train_step",
    "make_parallel_eval_step",
    "make_parallel_ckpt_extractor",
    "init_multihost",
    "local_shard",
    "Mesh",
    "rank_generator",
]
