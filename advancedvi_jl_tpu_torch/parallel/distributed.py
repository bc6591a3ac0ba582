"""Multi-process launch helpers (port of parallel/distributed.py).

One process per card (or per CPU rank in the tests), all running the same
program:

    from advancedvi_jl_tpu_torch.parallel import distributed
    distributed.initialize()            # torchrun's environment
    mesh = make_vi_mesh(...)            # spans every process
    q, infos, state = optimize(..., mesh=mesh)

launched as ``torchrun --nproc-per-node 4 script.py`` (or by hand with
``coordinator_address="host:port"``, ``num_processes`` and ``process_id``).
The group is NCCL when the process has a card and gloo otherwise (the CPU
tests); ``backend=`` picks one.  The parameters and optimizer state stay
replicated; a step's traffic is the reduction of the ELBO and the gradient
(and, with a data axis, of each log-density evaluation's likelihood sum).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


def free_port() -> int:
    """A free TCP port on localhost (for a group whose processes share one
    machine)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join (or make) the default process group.

    ``coordinator_address``: "host:port" of rank 0, with ``num_processes``
    and ``process_id``.  With none of the three, torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) is read;
    without it this process makes a group of one on a free localhost port.
    ``backend``: "nccl" or "gloo"; by default NCCL when CUDA is available,
    else gloo.  An NCCL group carries CUDA tensors over NCCL and CPU tensors
    (a state's host-side leaves) over gloo; an NCCL rank takes card
    ``LOCAL_RANK`` (else its rank modulo the cards).  No-op when the group
    exists already."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id as well"
            )
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
        rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    else:
        init_method = f"tcp://localhost:{free_port()}"
        world, rank = 1, 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def is_multi_host() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def sync_hosts(name: str = "avt_barrier") -> None:
    """Barrier over every process (e.g. before process 0 writes a
    checkpoint).  ``name`` labels the barrier, as in the JAX package."""
    if not is_multi_host():
        return
    dist.barrier()


def fully_replicated_host_local(x):
    """A replicated tensor as a numpy array on this host."""
    return x.detach().cpu().numpy()
