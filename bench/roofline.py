"""The work of the chunk scorer K1 (``guided_score_chunk``), counted from
the index and the schedule, and its least time on a card.

The work of one dispatched chunk is what its live tiles need, whatever
the kernel's arguments look like: each posting of each visited (query,
term, tile) run read once (docid, BM25 weight, learned weight: 12 bytes;
a product with the query weight and an add for each of the two weights),
the planner's two values per term of a visited tile read once (8 bytes),
and per doc slot of a visited tile the five output rows written once
(Global, Local, Rank and the two masks: 20 bytes; three combinations of
three operations each). Padding of a run up to the index's ``pad_len`` is
no work, and a skipped tile needs nothing. Nor is a pad slot: the facade
pads a batch's shorter queries with term 0 at weight 0 up to its longest,
and K1 reads those slots' runs, which add nothing to any score;
``k1_counts`` counts them apart.

The counts come in int64 from the index's runs of each row's terms over
the tiles it visited (the reference's ``visit_order_runs``), and the
visited tiles of a row are the first ``tiles_visited`` of its visit order:
within a chunk a tile is skipped when its bound is at most the
chunk-start threshold, bounds descend along the order, and the threshold
never falls.
"""
from __future__ import annotations

import torch

POSTING_BYTES = 12
POSTING_OPS = 4
TERM_BYTES = 8
SLOT_BYTES = 20
SLOT_OPS = 9


def live_postings(run_lengths, skip):
    """Postings of the visited runs of a chunk, per query: ``run_lengths``
    [B, C, Nq] (each (query, tile, term) run's postings in the index),
    ``skip`` [B, C] bool (a skipped tile); numpy or torch."""
    return (run_lengths * ~skip[..., None]).sum((-2, -1))


def k1_counts(runs, real, visited) -> dict:
    """Per row: ``postings`` of its own terms' runs over its visited
    tiles, ``pad_postings`` of its pad slots' runs over them,
    ``tile_terms`` (visited tile, own term) pairs and ``tiles`` visited.
    ``runs`` [R, T, W] postings of each (row, tile, slot) run, tiles in the
    row's visit order; ``real`` [R, W] bool, a query's own term;
    ``visited`` [R] tiles visited. Torch tensors, [R] int64 each."""
    seen = (torch.arange(runs.shape[1], device=runs.device)[None]
            < visited[:, None])                                 # [R, T]
    per = (runs * seen[..., None]).sum(1)                       # [R, W]
    real = real.to(torch.bool)
    visited = visited.long()
    return {"postings": (per * real).sum(-1),
            "pad_postings": (per * ~real).sum(-1),
            "tile_terms": visited * real.sum(-1),
            "tiles": visited}


def k1_work(postings: float, tile_terms: float, tiles: float,
            tile_size: int) -> dict:
    """Bytes and operations of ``postings`` live postings in ``tiles``
    visited tiles of ``tile_size`` slots, with ``tile_terms`` (visited
    tile, query term) pairs."""
    return {"bytes": POSTING_BYTES * postings + TERM_BYTES * tile_terms
            + SLOT_BYTES * tile_size * tiles,
            "ops": POSTING_OPS * postings + SLOT_OPS * tile_size * tiles}


def least_time_s(work: dict, peak: dict) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    float32 rate, and which of the two it is."""
    t_bytes = work["bytes"] / peak["hbm_bytes_per_s"]
    t_ops = work["ops"] / peak["fp32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
