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

import torch

from ..kernels import embedding_bag as eb


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table [V, D]; indices [B, L] (pad via weight 0) -> [B, D]. Also a
    stacked table [F, V, D] with indices [B, F, L] -> [B, F, D] (one kernel
    launch for all F fields). ``mode="mean"`` divides each bag by the sum
    of its weights (at least 1e-9)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode {mode!r} is not sum or mean")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=indices.device)
    out = eb.embedding_bag(table, indices.to(torch.int32).contiguous(),
                           weights.to(table.dtype).contiguous())
    if mode == "mean":
        denom = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
        out = out / denom.to(out.dtype)
    return out


def gather_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         mode: str = "sum") -> torch.Tensor:
    """``embedding_bag``'s contract (the same shapes, the stacked form
    included) with the reference's arithmetic: gather the rows, multiply
    each by its weight in the table's dtype and sum over the bag. Plain
    torch ops, so autograd differentiates it."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode {mode!r} is not sum or mean")
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=indices.device)
    idx = indices.long()
    if table.dim() == 3:                   # [F, V, D] with [B, F, L]
        field = torch.arange(table.shape[0], device=idx.device)[:, None]
        rows = table[field, idx]
    else:
        rows = table[idx]
    out = (rows * weights[..., None].to(rows.dtype)).sum(dim=-2)
    if mode == "mean":
        denom = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
        out = out / denom.to(out.dtype)
    return out


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
