"""Multi-process bring-up on `torch.distributed`.

Counterpart of `esctp1raytracer_tpu/parallel/distributed.py`. The process
group comes from the environment that `torchrun` sets (`MASTER_ADDR`,
`MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`) or
from explicit arguments named as JAX names them; in a single process with
neither, nothing is initialized.

The collective backend follows one rule, decided before the group is
made: "nccl" when CUDA is available and every rank on this host has a
card of its own (local world size <= the card count), with the rank bound
to `cuda:LOCAL_RANK`; "gloo" when ranks share one card or run on the CPU
(NCCL refuses two ranks on one GPU; gloo all-reduces CUDA tensors through
the host). An explicit `backend=` overrides the rule.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)


def choose_backend(local_world_size: int) -> str:
    """The rule above: nccl iff each local rank has its own card."""
    if torch.cuda.is_available() and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> int:
    """Initialize the default process group if configured; return the world size.

    `coordinator_address` is "host:port" of rank 0. No-op (returning 1) in a
    single process with neither arguments nor `WORLD_SIZE` in the
    environment; returns the world size of a group that already exists.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" not in env:
        return 1
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    address = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = backend or choose_backend(local_world)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank, **kwargs)
    logger.info("distributed: rank %d/%d (local %d/%d), backend %s", rank, world,
                local_rank, local_world, backend)
    return world
