"""Multi-process start-up (counterpart of the JAX package's
``parallel/hosts.py``): ``dist.init_process_group`` for a world that
another launcher started (``torchrun``, a cluster scheduler), and the
rank-0 gate for side effects."""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .. import resolve_device
from .launch import TIMEOUT, backend_for

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> bool:
    """Join the process group of a multi-process run.

    With ``coordinator_address`` (``host:port``) the group meets there as
    ``num_processes`` ranks, this one ``process_id``; without it, from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  The backend follows ``device`` (``cuda``
    unless named: NCCL, this process on card ``LOCAL_RANK``, or where that
    is not set on card ``rank mod visible cards``, so that the ranks of
    one host each take a card of their own; ``cpu``: gloo).  Returns
    False, doing nothing, only when no cluster is configured (no address
    given and neither ``WORLD_SIZE`` nor ``MASTER_ADDR`` set); every other
    error propagates.
    """
    if coordinator_address is None and not (
            "WORLD_SIZE" in os.environ or "MASTER_ADDR" in os.environ):
        logger.info("single-process mode (no cluster configured)")
        return False
    dev = resolve_device(device)
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    if dev.type == "cuda":
        dev = torch.device("cuda", _local_card(process_id))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend_for(dev), timeout=TIMEOUT, **kw)
    logger.info("multihost: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), dist.get_backend())
    return True


def _local_card(process_id: Optional[int]) -> int:
    """``LOCAL_RANK`` where the launcher set it, else this process's rank
    (``process_id``, or torchrun's ``RANK``) modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    return rank % torch.cuda.device_count()


def is_primary() -> bool:
    """True on rank 0, or where no process group is initialised: the rank
    that writes checkpoints, logs, plots and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0
