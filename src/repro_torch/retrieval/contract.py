"""Request/response contract of the unified search API.

One wire format for every engine: a :class:`SearchRequest` carries the
query batch plus the *query-time* knobs — retrieval depth ``k`` and an
optional ``threshold_factor`` override — while :class:`TwoLevelParams`
keeps only the pruning *policy* (alpha/beta/gamma, bounds, schedule).
A :class:`SearchResponse` is uniform across engines: original-space doc
ids, RankScores, the engine's stat counters, and wall-clock latency.

k-bucketing: per-request ``k`` is executed at the smallest bucket
>= k (``K_BUCKETS``) and the response is truncated back, as the reference
package does (there it bounds the jit compiles; here it keeps the results
equal to the reference's for the same request). For rank-safe
configurations the truncated prefix is bit-identical to running at
exactly ``k`` (the exact top-k is prefix-closed under the stable tie
discipline); guided configurations prune against the k-th threshold, so
exact-k semantics require ``k`` to sit on a bucket (or an exact-mode
retriever with ``k_buckets=None``).

Mixed-k batches: ``SearchRequest.k`` may also be a per-query sequence
([B] ints). The batch executes once at the bucket of the *largest*
requested depth and every row is truncated back to its own k (slots
beyond a row's depth hold the empty-queue sentinels: id -1, score
-inf). ``SearchResponse.ks`` always carries the per-row depths, so
downstream consumers never have to re-derive which columns are live.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Default execution depths. Chosen to cover the paper's sweep (Table 2 /
# Figure 1 use k in {10, ..., 1000}); anything above the largest bucket
# executes at its exact value.
K_BUCKETS = (10, 100, 1000)


def bucket_k(k: int, buckets=K_BUCKETS) -> int:
    """Smallest bucket >= k; k itself beyond the largest bucket.
    ``buckets=None`` disables bucketing (exact-k execution)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if buckets:
        for b in buckets:
            if k <= b:
                return b
    return k


def resolve_ks(k, batch_size: int) -> np.ndarray | None:
    """Normalize a per-query ``k`` to an int32 [batch_size] array.

    Returns None for the scalar (uniform-depth) invocation styles —
    ``None`` and plain ints keep the historical scalar path. Sequences
    and 0-d arrays of the right length become the per-row depth vector.
    """
    if k is None or isinstance(k, (int, np.integer)):
        return None
    ks = np.asarray(k)
    if ks.ndim == 0:  # np.int64(7) etc. — still a scalar request
        return None
    if not np.issubdtype(ks.dtype, np.integer):
        # fail loudly instead of silently truncating 5.9 -> 5 results
        if ks.size and (np.mod(ks, 1) != 0).any():
            raise ValueError(
                f"per-request k entries must be whole numbers, got {ks}")
    ks = ks.astype(np.int64).ravel()
    if ks.size != batch_size:
        raise ValueError(f"per-request k has {ks.size} entries for a "
                         f"batch of {batch_size} queries")
    if ks.size == 0 or (ks < 1).any():
        raise ValueError(f"per-request k entries must be >= 1, got {ks}")
    return ks.astype(np.int32)


@dataclasses.dataclass
class SearchRequest:
    """One retrieval call: a query batch plus query-time knobs.

    Sparse engines read ``terms``/``weights_b``/``weights_l`` ([B, Nq]
    arrays or ragged per-query lists — the Retriever pads ragged input
    with zero-weight terms, which score as no-ops). The dense engine
    reads ``dense`` ([B, D] float embeddings) instead.
    """
    terms: object = None       # [B, Nq] int32 term ids (or ragged lists)
    weights_b: object = None   # [B, Nq] f32 BM25-side query weights
    weights_l: object = None   # [B, Nq] f32 learned-side query weights
    dense: object = None       # [B, D] f32 query embeddings (dense engine)
    # None -> resolved by the Retriever (DEFAULT_K, honoring a legacy
    # TwoLevelParams(k=...) stash) so both invocation styles agree.
    # May be a per-query [B] sequence: the batch executes at the bucket
    # of the largest entry and each row is truncated to its own depth.
    k: int | object | None = None
    # Per-call pruning aggressiveness override (Table 3 / Fig. 3 sweeps).
    threshold_factor: float | None = None
    # Serving deadline, measured from scheduler submit. The scheduler
    # sheds entries whose budget ran out before pick (the handle fails
    # with DeadlineExceeded); engines themselves never read it.
    deadline_ms: float | None = None

    def batch_size(self) -> int:
        src = self.dense if self.terms is None else self.terms
        return len(src)


@dataclasses.dataclass
class SearchResponse:
    """Uniform engine output: ids/scores truncated to the requested k.

    ``k`` is the (maximum) requested depth — the column count of
    ``ids``/``scores``; ``ks`` the per-row depths (all equal to ``k``
    for scalar requests). Rows with ``ks[i] < k`` carry the empty-queue
    sentinels (-1 / -inf) beyond their own depth.
    """
    ids: np.ndarray            # [B, k] original-space docids (-1 = empty)
    scores: np.ndarray         # [B, k] f32 RankScore, descending
    engine: str                # registry name that served the call
    k: int                     # requested depth (max over rows)
    k_exec: int                # executed depth (the bucket)
    stats: dict                # engine counters (per-query arrays/floats)
    latency_ms: float          # wall-clock of the engine call
    # per-query host-loop timings (sequential engine only)
    latencies_ms: np.ndarray | None = None
    # per-row requested depths [B] int32 (always set by the Retriever)
    ks: np.ndarray | None = None
    # index generation that served the call (hot-swap bookkeeping; a
    # response may never mix rows from two generations)
    generation: int = 0
    # True when a degraded pool served this via a fallback route
    degraded: bool = False
