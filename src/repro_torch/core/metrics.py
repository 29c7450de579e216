"""Relevance metrics used in the paper: MRR@k, recall@k, nDCG@k.

Contract details the eval harness and its property
tests pin down:

- a document counts **once**: duplicate ids in a ranked list never
  inflate recall or DCG (first occurrence wins — the TREC convention);
- sentinel / invalid ids (< 0, the engines' empty-queue marker) are
  never relevant and never consume a "seen" slot;
- ``k`` larger than the ranked list degrades gracefully;
- ``mean_and_p99`` ignores non-finite latencies (in-flight NaN markers)
  and returns (nan, nan) for an empty or all-NaN sample instead of
  raising. Its p99 is the **exact-rank** quantile, not numpy's
  interpolated percentile — the reported tail is a latency some query
  actually took.
"""
from __future__ import annotations

import math

import numpy as np


def exact_quantile(samples, q: float) -> float:
    """Nearest-rank quantile: ``sorted(x)[ceil(q * n) - 1]``.

    Non-finite entries are dropped; an empty or all-non-finite sample
    yields NaN. ``q`` is clamped to (0, 1], so q=0 answers the minimum.
    """
    x = np.asarray(samples, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    if x.size == 0:
        return math.nan
    rank = min(max(int(math.ceil(q * x.size)), 1), int(x.size))
    return float(np.sort(x)[rank - 1])


def mrr_at_k(ranked_ids: np.ndarray, relevant: set[int], k: int = 10) -> float:
    for rank, d in enumerate(ranked_ids[:k], start=1):
        if int(d) >= 0 and int(d) in relevant:
            return 1.0 / rank
    return 0.0


def recall_at_k(ranked_ids: np.ndarray, relevant: set[int], k: int) -> float:
    if not relevant:
        return 0.0
    hits = {int(d) for d in ranked_ids[:k]
            if int(d) >= 0 and int(d) in relevant}
    return len(hits) / len(relevant)


def ndcg_at_k(ranked_ids: np.ndarray, gains: dict[int, float], k: int = 10
              ) -> float:
    """nDCG@k with graded gains (binary dict -> standard nDCG)."""
    dcg = 0.0
    seen: set[int] = set()
    for rank, d in enumerate(ranked_ids[:k], start=1):
        d = int(d)
        if d < 0 or d in seen:
            continue   # sentinels never score; dups never earn gain twice
        seen.add(d)
        g = gains.get(d, 0.0)
        if g:
            dcg += (2.0 ** g - 1.0) / np.log2(rank + 1)
    ideal = sorted(gains.values(), reverse=True)[:k]
    idcg = sum((2.0 ** g - 1.0) / np.log2(r + 1)
               for r, g in enumerate(ideal, start=1))
    return dcg / idcg if idcg > 0 else 0.0


def mean_and_p99(latencies_ms: np.ndarray) -> tuple[float, float]:
    """MRT and tail latency as reported in the paper's tables.

    Non-finite entries (NaN in-flight markers, inf) are dropped; an
    empty or fully non-finite sample yields (nan, nan) rather than a
    numpy error, so callers can aggregate partial workloads safely."""
    lat = np.asarray(latencies_ms, dtype=np.float64).ravel()
    lat = lat[np.isfinite(lat)]
    if lat.size == 0:
        return (float("nan"), float("nan"))
    return float(lat.mean()), exact_quantile(lat, 0.99)


def evaluate_run(ids: np.ndarray, qrels: list[set[int]], k: int,
                 mrr_cutoff: int = 10) -> dict:
    """Aggregate MRR@cutoff / recall@k / nDCG@10 over a query batch."""
    mrr, rec, ndcg = [], [], []
    for row, rel in zip(ids, qrels):
        mrr.append(mrr_at_k(row, rel, mrr_cutoff))
        rec.append(recall_at_k(row, rel, k))
        ndcg.append(ndcg_at_k(row, {d: 1.0 for d in rel}, 10))
    return {"mrr": float(np.mean(mrr)), "recall": float(np.mean(rec)),
            "ndcg": float(np.mean(ndcg))}
