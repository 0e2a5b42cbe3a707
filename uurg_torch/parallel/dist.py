"""Process-group start and the rank helpers.

Port of ``uurg_tpu/parallel/dist.py``. The JAX package wires every host
into one runtime with ``jax.distributed.initialize``; here one process
drives one card and the processes meet in a ``torch.distributed`` group:
NCCL between CUDA cards, gloo on the CPU. ``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; a plain
``python`` run has none of them and stays one process without a group.
"""
from __future__ import annotations

import logging
import os
import socket

import torch
import torch.distributed as dist

log = logging.getLogger("uurg_torch.dist")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of processes in the default group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """The rank among this host's processes (``LOCAL_RANK``, which
    ``torchrun`` sets); the global rank when it is not set."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def _backend(device) -> str:
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> bool:
    """Join the default process group, once. ``coordinator``
    (``host:port``), ``num_processes`` and ``process_id`` name it;
    without them ``torchrun``'s environment does, and without that this is
    a no-op (one process, as the JAX function is on one host). NCCL when
    ``device`` is CUDA (the default where CUDA is available), gloo for the
    CPU; under NCCL the process takes card ``LOCAL_RANK``. Returns whether
    a group is up."""
    if is_initialized():
        return True
    backend = _backend(device)
    if coordinator:
        init = f"tcp://{coordinator}"
        world = int(num_processes if num_processes is not None else 1)
        r = int(process_id if process_id is not None else 0)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = "env://"
        world, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        log.debug("no coordinator and no torchrun environment: one process")
        return False
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", r)))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=r)
    log.info("distributed: rank %d of %d on %s", r, world, backend)
    return True


def initialize_single(device=None) -> None:
    """A group of this process alone on a free localhost port (a one-rank
    mesh without ``torchrun``); nothing when a group is up."""
    if not is_initialized():
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier over the default group (around host-side file rendezvous:
    rank 0 writes, the others read after); nothing without a group."""
    if is_initialized():
        log.debug("barrier %s", tag)
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
