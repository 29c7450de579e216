"""Sparse weight models (term-major CSR) and exhaustive scoring.

A ``SparseModel`` is one weighting model over a corpus: BM25 or a learned
impact model (SPLADE / uniCOIL / DeepImpact style). Postings are term-major
CSR, docids sorted ascending within each term — the layout every other core
module (alignment, index build, oracle) consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SparseModel:
    """One weighting model in term-major CSR form (host-side, numpy)."""

    n_docs: int
    n_terms: int
    indptr: np.ndarray   # [n_terms + 1] int64
    docids: np.ndarray   # [nnz] int32, sorted ascending within each term
    weights: np.ndarray  # [nnz] float32

    @property
    def nnz(self) -> int:
        return int(self.docids.shape[0])

    def postings(self, term: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[term], self.indptr[term + 1]
        return self.docids[s:e], self.weights[s:e]

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_terms + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0)
        for t in range(min(self.n_terms, 64)):  # spot-check sortedness
            d, _ = self.postings(t)
            assert np.all(np.diff(d) > 0), f"term {t} postings unsorted/dup"

    def max_weights(self) -> np.ndarray:
        """Per-term maximum contribution sigma[t] (0 for empty lists)."""
        out = np.zeros(self.n_terms, dtype=np.float32)
        np.maximum.at(out, np.repeat(np.arange(self.n_terms),
                                     np.diff(self.indptr)), self.weights)
        return out


def from_coo(n_docs: int, n_terms: int, terms: np.ndarray, docs: np.ndarray,
             weights: np.ndarray) -> SparseModel:
    """Build a SparseModel from unsorted COO triples, deduping (term,doc)."""
    key = terms.astype(np.int64) * n_docs + docs.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, terms, docs, weights = key[order], terms[order], docs[order], weights[order]
    keep = np.concatenate([[True], np.diff(key) != 0])
    terms, docs, weights = terms[keep], docs[keep], weights[keep]
    counts = np.bincount(terms, minlength=n_terms)
    indptr = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return SparseModel(n_docs, n_terms, indptr,
                       docs.astype(np.int32), weights.astype(np.float32))


def score_all(model: SparseModel, q_terms: np.ndarray,
              q_weights: np.ndarray | None = None) -> np.ndarray:
    """Exhaustively score every document: S[d] = sum_t qw_t * w(t, d)."""
    scores = np.zeros(model.n_docs, dtype=np.float64)
    if q_weights is None:
        q_weights = np.ones(len(q_terms), dtype=np.float32)
    for t, qw in zip(q_terms, q_weights):
        d, w = model.postings(int(t))
        scores[d] += float(qw) * w.astype(np.float64)
    return scores.astype(np.float32)


def exhaustive_topk(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (ids, scores), score-desc with docid-asc tiebreak (stable)."""
    k = min(k, len(scores))
    # argsort on (-score, docid): lexsort keys are last-key-primary.
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return order.astype(np.int32), scores[order]
