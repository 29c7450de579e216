"""Sparse and ragged primitives of the recsys and GNN families.

The port of ``repro.sparse_ops``: ``embedding_bag`` (gather and weighted
sum, a bag padded by weight-0 slots) goes through the hand-written
embedding-bag kernel on CUDA tensors (``kernels.embedding_bag``), which
has no backward; ``gather_embedding_bag`` computes the same bags with
plain torch ops, as the reference's jnp ``embedding_bag`` does, so
autograd differentiates it: the train path's bag. ``segment_softmax``,
``scatter_mean`` and ``degree`` are scatters over a segment index
(``scatter_reduce`` / ``index_add``).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from ..dist.sharding import as_placed, dim0_placements
from ..kernels import embedding_bag as eb


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table [V, D]; indices [B, L] (pad via weight 0) -> [B, D]. Also a
    stacked table [F, V, D] with indices [B, F, L] -> [B, F, D] (one kernel
    launch for all F fields). ``mode="mean"`` divides each bag by the sum
    of its weights (at least 1e-9). A DTensor table split on its rows is
    read where its rows live (``take_rows``), and the kernel adds each
    bag's rows over a table of them alone, in the same order as over the
    whole table."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode {mode!r} is not sum or mean")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=indices.device)
    idx = indices.to(torch.int32).contiguous()
    w = weights.to(table.dtype).contiguous()
    if _row_split(table) or (_is_dtensor(table)
                             and not _is_dtensor(indices)):
        out = _bag_split_rows(table, idx, w)
    else:
        out = eb.embedding_bag(table, idx, w)
    if mode == "mean":
        denom = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
        out = out / denom.to(out.dtype)
    return out


def gather_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         mode: str = "sum") -> torch.Tensor:
    """``embedding_bag``'s contract (the same shapes, the stacked form
    included) with the reference's arithmetic: gather the rows
    (``take_rows``), multiply each by its weight in the table's dtype and
    sum over the bag. Plain torch ops, so autograd differentiates it."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode {mode!r} is not sum or mean")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=indices.device)
    rows = take_rows(table, indices)
    out = (rows * weights[..., None].to(rows.dtype)).sum(dim=-2)
    if mode == "mean":
        denom = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
        out = out / denom.to(out.dtype)
    return out


def _rows(table, ids):
    """``table[ids]``; for a stacked table [F, V, D], ids [..., F, L] read
    table f at field f."""
    if table.dim() == 3:
        field = torch.arange(table.shape[0], device=ids.device)[:, None]
        return table[field, ids]
    return table[ids]


def _is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _row_split(table) -> list:
    """The mesh dims of more than one rank that split a DTensor table on
    its rows (dim -2); [] for anything else."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(table, DTensor):
        return []
    mesh, rows = table.device_mesh, table.dim() - 2
    return [m for m, p in enumerate(table.placements)
            if p == Shard(rows) and mesh.shape[m] > 1]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``table[ids]`` of a [V, D] table ([..., D]), or of a stacked
    [F, V, D] table with ids [..., F, L]. A DTensor table split evenly on
    its rows is not gathered: each rank reads the rows it holds (zeros for
    the others) and a sum over the splitting mesh dims (an all-reduce;
    every row comes from one rank, so it is exact) gives each rank its
    rows. The rows (a DTensor) keep the ids' split (dim 0, on the other
    mesh dims; plain ids are whole on every rank). A table split
    otherwise is gathered whole first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return _rows(table, ids.long())
    mesh, rows_dim = table.device_mesh, table.dim() - 2
    split = _row_split(table)
    if table.shape[rows_dim] % math.prod(mesh.shape[m] for m in split) or any(
            not p.is_replicate() and mesh.shape[m] > 1 and m not in split
            for m, p in enumerate(table.placements)):
        split = []
        table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    place = dim0_placements(ids, mesh, split)
    idx = as_placed(ids, mesh, place).to_local().long()
    local = table.to_local()
    if split:
        n = local.shape[rows_dim]
        coord, first = mesh.get_coordinate(), 0
        for m in split:
            first = first * mesh.shape[m] + coord[m]
        idx = idx - first * n
        mine = (idx >= 0) & (idx < n)
        got = torch.where(mine[..., None], _rows(local, idx.clamp(0, n - 1)),
                          0)
        out = DTensor.from_local(got, mesh, [
            Partial() if m in split else p for m, p in enumerate(place)],
            run_check=False).redistribute(mesh, place)
    else:
        out = DTensor.from_local(_rows(local, idx), mesh, place,
                                 run_check=False)
    return out


def _bag_split_rows(table, indices, weights):
    """``embedding_bag`` over a DTensor table split on its rows: the bags'
    rows gathered where they live (``take_rows``), then the kernel over a
    table of those rows alone, each bag's ids renumbered into them, so it
    adds the same values in the same order as over the whole table."""
    from torch.distributed.tensor import DTensor
    rows = take_rows(table, indices)
    mesh, place = table.device_mesh, list(rows.placements)
    rows = rows.to_local()
    w = as_placed(weights, mesh, place).to_local()
    b, n = rows.shape[0], rows.shape[-2]
    if table.dim() == 3:                      # rows [B, F, L, D]
        f = rows.shape[1]
        sub = rows.transpose(0, 1).reshape(f, b * n, -1)
        ids = torch.arange(b * n, dtype=torch.int32, device=rows.device
                           ).view(b, 1, n).expand(b, f, n)
    else:                                     # rows [B, L, D]
        sub = rows.reshape(b * n, -1)
        ids = torch.arange(b * n, dtype=torch.int32,
                           device=rows.device).view(b, n)
    out = eb.embedding_bag(sub.contiguous(), ids.contiguous(), w)
    if not isinstance(indices, DTensor):
        return out
    return DTensor.from_local(out, mesh, place, run_check=False)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over variable-size segments (edge-softmax for GAT-style)."""
    seg = segment_ids.long()
    seg_max = torch.full((num_segments,) + scores.shape[1:], -torch.inf,
                         dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(0, _expand(seg, scores), scores, "amax")
    ex = torch.exp(scores - seg_max[seg])
    seg_sum = torch.zeros_like(seg_max).index_add_(0, seg, ex)
    return ex / torch.clamp_min(seg_sum[seg], 1e-30)


def scatter_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    seg = segment_ids.long()
    s = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                    device=values.device).index_add_(0, seg, values)
    c = torch.zeros(num_segments, dtype=values.dtype,
                    device=values.device).index_add_(
        0, seg, torch.ones(seg.shape, dtype=values.dtype,
                           device=values.device))
    c = torch.clamp_min(c, 1.0)
    return s / c[:, None] if values.dim() > 1 else s / c


def degree(edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    return torch.zeros(num_nodes, dtype=torch.float32,
                       device=edge_dst.device).index_add_(
        0, edge_dst.long(), torch.ones(edge_dst.shape, dtype=torch.float32,
                                       device=edge_dst.device))


def _expand(seg, like):
    """Segment ids broadcast over the trailing dims of ``like``."""
    return seg.view((-1,) + (1,) * (like.dim() - 1)).expand_as(like)
