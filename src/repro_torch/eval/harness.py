"""Relevance evaluation: engine -> metrics-next-to-latency.

The paper's whole argument is a *joint* claim — guided traversal buys
mean response time without giving up rank quality (until it does, at
small k under misalignment). That claim is only checkable when MRR/nDCG/
recall and MRT come out of the same run over the same judged queries;
this module is that seam (the JAX package's ``benchmarks/quality_bench.py``
drives its twin to produce ``BENCH_quality.json``).

Metric cut-offs follow the paper's tables: MRR@10, nDCG@10,
Recall@{10, 100} (so rankings must reach depth >= 100 for the full set;
shallower rankings simply score what they have).
"""
from __future__ import annotations

import time

import numpy as np

from ..core.metrics import (mean_and_p99, mrr_at_k, ndcg_at_k,
                            recall_at_k)

# (metric name, cutoff) grid of the reported quality columns
QUALITY_METRICS = (("mrr", 10), ("ndcg", 10), ("recall", 10),
                   ("recall", 100))


def evaluate_ranking(ids: np.ndarray, qrels: list[dict[int, float]],
                     ) -> dict[str, float]:
    """Mean quality metrics of one ranked-id batch against graded qrels
    (host numpy: the engines return their results to the host).

    ``ids`` [B, depth] original docids (-1 sentinels ignored by the
    metric guards); ``qrels`` per-query docid -> gain. Binary metrics
    (MRR, recall) treat any positive gain as relevant; nDCG uses the
    gains. Returns ``{"mrr@10": ..., "ndcg@10": ..., "recall@10": ...,
    "recall@100": ...}``."""
    ids = np.asarray(ids)
    if ids.shape[0] != len(qrels):
        raise ValueError(f"{ids.shape[0]} ranked rows vs {len(qrels)} "
                         f"judged queries")
    acc: dict[str, list[float]] = {f"{m}@{c}": [] for m, c in QUALITY_METRICS}
    for row, gains in zip(ids, qrels):
        rel = {d for d, g in gains.items() if g > 0}
        acc["mrr@10"].append(mrr_at_k(row, rel, 10))
        acc["ndcg@10"].append(ndcg_at_k(row, gains, 10))
        acc["recall@10"].append(recall_at_k(row, rel, 10))
        acc["recall@100"].append(recall_at_k(row, rel, 100))
    return {name: float(np.mean(vals)) for name, vals in acc.items()}


def evaluate_retriever(retriever, queries: dict,
                       qrels: list[dict[int, float]], *, k: int = 100,
                       threshold_factor: float | None = None,
                       warmup: bool = True, repeats: int = 1) -> dict:
    """Run one engine over a judged query batch: quality + timing.

    ``queries`` is the kwargs dict ``Retriever.search`` takes (``terms``
    / ``weights_b`` / ``weights_l`` and optionally ``dense``). A warmup
    call absorbs first-call costs (kernel builds, allocator growth) so
    ``mrt_ms`` (mean per-query response time, the paper's MRT) reflects
    steady-state execution; ``repeats`` timed calls feed the p99. The
    window of each call ends with its results on the host."""
    if warmup:
        retriever.search(k=k, threshold_factor=threshold_factor, **queries)
    lats = []
    resp = None
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        resp = retriever.search(k=k, threshold_factor=threshold_factor,
                                **queries)
        lats.append((time.perf_counter() - t0) * 1e3)
    n_q = resp.ids.shape[0]
    per_query = np.asarray(lats) / max(n_q, 1)
    mrt, p99 = mean_and_p99(per_query)
    out = evaluate_ranking(resp.ids, qrels)
    out.update(engine=retriever.engine_name, k=int(k),
               mrt_ms=mrt, p99_ms=p99, n_queries=int(n_q))
    return out
