"""Data parallelism over the ranks (counterpart of
disprcnn_tpu/parallel/mesh.py; reference tools/train_net.py:36-41 DDP).

The JAX package runs one SPMD step over a mesh: the batch sharded on
"data", parameters replicated, the gradient all-reduce inserted by XLA, so
its step on n devices computes its one-device step at the global batch.
Here each rank is a process with its share of the global batch, and the
step reaches the same result through explicit collectives:
- ``sum_over_ranks``: counts (loss normalizers) summed without a gradient;
- ``sum_over_ranks_autograd``: BatchNorm's moments summed with the
  gradient's cross-rank terms (its backward sums the upstream gradients);
- ``all_reduce_grads``: the gradients summed in one flat buffer;
- ``replicate``: rank 0's parameters and buffers broadcast at start;
- ``shard_batch``: this rank's rows of a batch-major tensor made for the
  global batch, as the loader shards the samples (interleaved: global
  sample j * world + rank is this rank's sample j).
On one process every helper is the identity.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from .multihost import process_count, process_index


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, without a gradient (x itself on one
    process)."""
    if process_count() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def sum_over_ranks_autograd(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks; the gradient of each rank's x is the sum
    of the upstream gradients of every rank (x itself on one process)."""
    if process_count() == 1:
        return x
    return dist_fn.all_reduce(x)


def all_reduce_grads(grads) -> None:
    """Sum the gradient tensors over the ranks in place, through one flat
    buffer."""
    if process_count() == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def replicate(module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank."""
    if process_count() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def shard_batch(x, batch: int):
    """This rank's share of `x`, made for a global batch of `batch`
    samples: a tensor whose first axis holds `batch` equal blocks of rows,
    one a sample (e.g. (batch * slots, ...)), or a dataclass or dict of
    such tensors. Global sample j * world + rank becomes this rank's
    sample j (the loader's interleaved shards)."""
    world = process_count()
    if world == 1:
        return x
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not split over {world} ranks")
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: shard_batch(getattr(x, f.name), batch)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: shard_batch(v, batch) for k, v in x.items()}
    if x.shape[0] % batch:
        raise ValueError(f"{tuple(x.shape)} is not made of {batch} samples' rows")
    rows = x.reshape(batch // world, world, x.shape[0] // batch, *x.shape[1:])
    return rows[:, process_index()].reshape(-1, *x.shape[1:])
