"""Processes over torch.distributed (counterpart of
disprcnn_tpu/parallel/multihost.py; reference utils/comm.py:12-117).

One process a card, as torchrun starts them: ``init_distributed`` reads
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, picks the
rank's device and joins the process group. With WORLD_SIZE unset or 1 it
creates no group, and every helper here is the identity (or a no-op), so
a one-process run does exactly what it did without this module.

Predictions are fixed-shape padded numpy arrays, so gathering them is a
``dist.all_gather`` of equal-shaped tensors: no pickling over the wire.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def rank_device(device: Optional[str | torch.device] = None) -> torch.device:
    """This rank's device: `device` as given where it names an index or the
    CPU; "cuda" (or None) means cuda:LOCAL_RANK."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def init_distributed(backend: str = "nccl", device: Optional[str | torch.device] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group of torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) on `backend`, and return this
    rank's device (``rank_device``). With WORLD_SIZE unset or 1 no group
    is created. NCCL needs a card of its own for each rank: a rank whose
    device is not cuda:LOCAL_RANK, or more ranks on the host than cards,
    raises here (NCCL itself would hang at the first collective). Every
    collective of the group times out after `timeout`."""
    device = rank_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return device
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if device.type != "cuda" or device.index != local or local_world > cards:
            raise RuntimeError(
                f"nccl needs one card a rank: rank {rank} (local rank {local} of "
                f"{local_world} on this host) asks for {device} with {cards} card(s) here. "
                "Give each rank cuda:LOCAL_RANK, or use --dist-backend gloo to run several "
                "ranks on one card")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                            rank=rank, timeout=timeout)
    return device


def synchronize() -> None:
    """Barrier across the ranks (reference utils/comm.py synchronize)."""
    if process_count() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the group's tensors must lie: the current card for NCCL, the
    CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_predictions(local: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Equal-shaped arrays of every rank, concatenated along the first axis
    in rank order, on every rank (the identity on one process)."""
    world = process_count()
    if world == 1:
        return local
    dev = collective_device()
    out = {}
    for k, v in local.items():
        v = np.ascontiguousarray(v)
        t = torch.from_numpy(v.view(np.uint8) if v.dtype == np.bool_ else v).to(dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        a = torch.cat(parts).cpu().numpy()
        out[k] = a.view(np.bool_) if v.dtype == np.bool_ else a
    return out
