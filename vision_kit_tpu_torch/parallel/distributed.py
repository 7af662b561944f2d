"""Multi-process initialisation: one process per GPU, each a data shard.

Counterpart of vision_kit_tpu/parallel/distributed.py, over
torch.distributed in place of jax.distributed. A launch names a rendezvous
address, a world size and a rank: by argument, else as torchrun sets them
(MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), else by the
JAX package's variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID). An argument wins over the environment.

Unlike the JAX version, a rendezvous that fails raises: the JAX version
logs and goes on single-host, which here would train on one card of the N
the launch asked for, with every other process waiting on it.

After it, parallel/mesh.py:make_mesh() spans the process group, and the
training step all-reduces over it (train/step.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from vision_kit_tpu_torch.utils.logging_utils import logger


def _env_int(*names: str) -> int | None:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _env_address() -> str | None:
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return os.environ.get("JAX_COORDINATOR_ADDRESS") or None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group when the launch asks for more than one
    process, or names its address by argument. Returns True when it
    initialised the group, False for a single process (a no-op).

    backend: "nccl" when CUDA is available, else "gloo"; "gloo" on CUDA
    tensors lets several processes share one card (NCCL refuses that).
    On CUDA the process binds cuda:LOCAL_RANK (0 when unset)."""
    explicit = coordinator_address is not None
    address = coordinator_address or _env_address()
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "JAX_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int("RANK", "JAX_PROCESS_ID")
    if not explicit and (world is None or world <= 1):
        return False
    if address is None:
        raise RuntimeError(f"a world of {world} processes needs a rendezvous address "
                           "(MASTER_ADDR and MASTER_PORT, or JAX_COORDINATOR_ADDRESS)")
    if world is None or rank is None:
        raise RuntimeError(f"rendezvous at {address} needs a world size and a rank "
                           f"(got {world} and {rank})")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    logger.info("torch.distributed initialised: rank %d of %d over %s at %s", rank,
                world, backend, address)
    return True
