"""Collectives over a ``torch.distributed`` process group.

Semantics follow the JAX package's ``repro.dist.collectives``, where the
input's leading dim is the *device contribution* axis of a mesh. Here
every rank is one device and passes its own contribution: the sums return
the elementwise sum of all ranks' tensors on every rank, and the gathers
stack or concatenate them in rank order. In a group of size 1 every
collective is the identity.

``group`` is a process group (``None``: the default group). The backend
follows the tensors: gloo for CPU tensors, NCCL for CUDA tensors; the
caller initialises the group (``torch.distributed.init_process_group``)
with the address, world size and rank. The sums run the backend's
all-reduce (NCCL's ring on the card), and ``hierarchical_all_reduce``
composes two of them, within the inner groups and then across the outer
groups, as the reference composes two rings.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' ``x`` summed, on every rank (a new tensor)."""
    out = x.clone()
    if _size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def ring_gather_stack(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``local`` stacked on a new leading axis in rank order
    ([*] -> [n, *]; entry j is rank j's contribution), on every rank. The
    primitive behind ``ring_all_gather`` and the sharded-retrieval queue
    merge (``serve.sharded``), which needs the stacked form to keep the
    shard-order stable-tie rule of the single-device queue."""
    n = _size(group)
    if n == 1:
        return local[None]
    local = local.contiguous()
    out = torch.empty((n,) + tuple(local.shape), dtype=local.dtype,
                      device=local.device)
    dist.all_gather(list(out.unbind(0)), local, group=group)
    return out


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank."""
    return _sum(x, group)


def hierarchical_all_reduce(x: torch.Tensor, inner_group,
                            outer_group) -> torch.Tensor:
    """Two-phase all-reduce: sum within ``inner_group`` (the ranks of one
    pod), then across ``outer_group`` (this rank's peers in the other
    pods). With the world split into equal inner groups and outer groups
    that take one rank of each, the result is the sum over all ranks."""
    return _sum(_sum(x, inner_group), outer_group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i ends with chunk i (along dim 0) of the summed contributions.
    The contribution's row count must divide by the group size, so the
    chunks partition it exactly."""
    n = _size(group)
    rows = x.shape[0]
    if n > 1 and rows % n:
        raise ValueError(
            f"reduce_scatter needs contribution rows ({rows}) divisible "
            f"by the group size ({n}) to scatter without overlap")
    chunk = rows // n
    i = dist.get_rank(group) if n > 1 else 0
    return _sum(x, group)[i * chunk:(i + 1) * chunk]


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, on every
    rank."""
    out = ring_gather_stack(x, group)
    return out.reshape((out.shape[0] * x.shape[0],) + tuple(x.shape[1:]))
