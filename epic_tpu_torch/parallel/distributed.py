"""Process groups for data-parallel training and multi-process RD sweeps.

``init_multihost`` joins ``torch.distributed`` over ``tcp://``: every
process is told the address, the number of processes and its rank (nothing
on the machine announces a cluster). The backend is the caller's choice
and is never switched silently: "nccl" for CUDA ranks, each on its own GPU,
"gloo" for CPU ranks or for host tensors (several processes sharing one
GPU gather their host rows over gloo). ``local_shard`` gives each process
its contiguous part of a global work list, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> bool:
    """Join the process group at ``coordinator_address`` ("host:port" or
    "tcp://host:port") as rank ``process_id`` of ``num_processes`` with
    ``backend`` ("nccl" or "gloo"). One process and no address: a no-op
    that returns False. Returns True once joined."""
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs the coordinator address, "
                         "the number of processes and this process's id")
    addr = coordinator_address if coordinator_address.startswith("tcp://") \
        else "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
    return True


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_shard(items: Sequence, process_index: Optional[int] = None,
                process_count: Optional[int] = None):
    """This process's contiguous shard of a global work list: ceil(n /
    count) items each, the last ones shorter (or empty)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = (len(items) + pc - 1) // pc
    return items[pi * per:(pi + 1) * per]
