"""Process-group initialisation for data- and tensor-parallel runs.

Port of ``omr_a2s_multimodal_transformer_tpu/parallel/multihost.py``:
``initialize()`` becomes ``torch.distributed.init_process_group``. Nothing
tells a process of a cluster, so the address, the world size and the rank
come from the arguments, else from the JAX package's variables
``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES`` and ``PROCESS_ID``,
else from torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``. Explicit arguments win over the environment.

The backend is NCCL when each rank has a GPU of its own, and gloo when the
ranks run on the CPU or share a GPU (NCCL refuses two ranks on one card).
The group waits at most ``TIMEOUT_S`` seconds for a collective, so a rank
that dies fails the others instead of hanging them.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 300.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value is not None and value != "":
            return int(value)
    return None


def launch_config(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> dict:
    """(address, world size, rank) from the arguments, the JAX package's
    variables, then torchrun's. ``address`` is "host:port" or None."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not addr and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    n = num_processes if num_processes else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    return {"address": addr, "world_size": n, "rank": pid}


def choose_backend(device: Optional[str], local_world: int) -> str:
    """NCCL when the ranks run on CUDA and each has a card of its own."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= local_world > 0:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with the JAX package's
    environment fallbacks. ``device`` ("cuda" unless given) picks the
    backend (``choose_backend``); under NCCL the process takes the card of
    its local rank."""
    cfg = launch_config(coordinator_address, num_processes, process_id)
    if cfg["world_size"] is None or cfg["rank"] is None or not cfg["address"]:
        raise ValueError(f"initialize needs an address, a world size and a rank, got {cfg}: pass them or set "
                         "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID (or torchrun's MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    local_world = _env_int("LOCAL_WORLD_SIZE") or cfg["world_size"]
    backend = choose_backend(device, local_world)
    if backend == "nccl":  # the card of its rank on the host (torchrun's LOCAL_RANK, else the rank)
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((cfg["rank"] if local is None else local) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{cfg['address']}", world_size=cfg["world_size"],
                            rank=cfg["rank"], timeout=datetime.timedelta(seconds=TIMEOUT_S))


def launched() -> bool:
    """Whether the environment describes a run of more than one process."""
    n = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    return n is not None and n > 1


def is_primary() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":  # NCCL's barrier is a collective on this rank's card (set by initialize)
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


@contextlib.contextmanager
def primary_first():
    """Rank 0 runs the block before the other ranks do (a cache that the
    first writes and the others read)."""
    if not is_primary():
        barrier()
    try:
        yield
    finally:
        if is_primary():
            barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
