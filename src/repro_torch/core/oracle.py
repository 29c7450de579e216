"""Sequential numpy DAAT 2GTI oracle — the paper's exact control flow.

Implements document-at-a-time MaxScore with two-level guided pruning and
per-document threshold updates (Section 4.1 verbatim): term partitioning via
the alpha-combined prefix, pivot selection from essential cursors, descending
local refinement against theta_Lo with the beta-combined bound, and the
three-queue discipline (locally-pruned docs still enter Q_Rk with partial
RankScore). Used to cross-validate the tile-scan engine; also provides the
exhaustive ranked lists R_x and the two-stage baseline R2_{alpha,gamma}.
"""
from __future__ import annotations

import heapq

import numpy as np

from .align import MergedPostings
from .twolevel import TwoLevelParams, resolve_k


class _TopK:
    """Min-heap top-k queue with (score, -docid) ordering (docid tiebreak)."""

    def __init__(self, k: int):
        self.k = k
        self.heap: list[tuple[float, int]] = []

    @property
    def threshold(self) -> float:
        return self.heap[0][0] if len(self.heap) >= self.k else -np.inf

    def push(self, score: float, docid: int) -> None:
        item = (score, -docid)
        if len(self.heap) < self.k:
            heapq.heappush(self.heap, item)
        elif item > self.heap[0]:
            heapq.heapreplace(self.heap, item)

    def sorted_desc(self) -> tuple[np.ndarray, np.ndarray]:
        items = sorted(self.heap, reverse=True)
        ids = np.array([-d for _, d in items], dtype=np.int32)
        vals = np.array([s for s, _ in items], dtype=np.float32)
        pad = self.k - len(items)
        if pad:
            ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
            vals = np.concatenate([vals, np.full(pad, -np.inf, np.float32)])
        return ids, vals


def score_all_merged(merged: MergedPostings, q_terms, qw_b, qw_l, x: float
                     ) -> np.ndarray:
    """Exhaustive x-combined scores over all docs: R_x ranking source."""
    s = np.zeros(merged.n_docs, dtype=np.float64)
    for t, wb_q, wl_q in zip(q_terms, qw_b, qw_l):
        d, wb, wl = merged.postings(int(t))
        s[d] += x * wb_q * wb + (1.0 - x) * wl_q * wl
    return s.astype(np.float32)


def ranked_list(merged: MergedPostings, q_terms, qw_b, qw_l, x: float,
                k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k of R_x with docid-asc tiebreak."""
    s = score_all_merged(merged, q_terms, qw_b, qw_l, x)
    order = np.lexsort((np.arange(len(s)), -s))[:k]
    return order.astype(np.int32), s[order]


def two_stage(merged: MergedPostings, q_terms, qw_b, qw_l, alpha: float,
              gamma: float, k: int) -> tuple[np.ndarray, np.ndarray]:
    """R2_{alpha,gamma}: fetch top-k of R_alpha, rerank by R_gamma scores."""
    ids, _ = ranked_list(merged, q_terms, qw_b, qw_l, alpha, k)
    s = score_all_merged(merged, q_terms, qw_b, qw_l, gamma)
    sub = s[ids]
    order = np.lexsort((ids, -sub))
    return ids[order], sub[order]


def daat_2gti(merged: MergedPostings, q_terms, qw_b, qw_l,
              params: TwoLevelParams, k: int | None = None):
    """Paper-faithful sequential 2GTI. Returns (ids, scores, stats).
    ``k`` is the per-call retrieval depth (legacy ``params.k`` fallback)."""
    a, b, g = params.alpha, params.beta, params.gamma
    F = params.threshold_factor
    k = resolve_k(params, k)
    nq = len(q_terms)
    lists = []
    sig_b = np.zeros(nq, np.float64)
    sig_l = np.zeros(nq, np.float64)
    for i, (t, wbq, wlq) in enumerate(zip(q_terms, qw_b, qw_l)):
        d, wb, wl = merged.postings(int(t))
        wb = wb.astype(np.float64) * float(wbq)
        wl = wl.astype(np.float64) * float(wlq)
        lists.append((d.astype(np.int64), wb, wl))
        if len(d):
            sig_b[i] = wb.max()
            sig_l[i] = wl.max()
    order = np.argsort(a * sig_b + (1 - a) * sig_l, kind="stable")
    lists = [lists[i] for i in order]
    sig_b, sig_l = sig_b[order], sig_l[order]
    m_alpha = a * sig_b + (1 - a) * sig_l
    prefix_alpha = np.cumsum(m_alpha)
    m_beta = b * sig_b + (1 - b) * sig_l
    prefix_beta = np.cumsum(m_beta)

    q_gl, q_lo, q_rk = _TopK(k), _TopK(k), _TopK(k)
    cursors = [0] * nq
    docs_evaluated = 0
    docs_frozen = 0
    while True:
        th_gl = q_gl.threshold * F
        th_lo = q_lo.threshold * F
        essential = prefix_alpha > th_gl  # suffix in sorted order
        if not essential.any():
            break  # every doc bounded below theta_Gl: traversal terminates
        # pivot doc: min current docid among essential cursors
        d = None
        for i in range(nq):
            if essential[i] and cursors[i] < len(lists[i][0]):
                cd = lists[i][0][cursors[i]]
                d = cd if d is None else min(d, cd)
        if d is None:
            break
        # advance non-essential cursors to >= d (skip pointers)
        for i in range(nq):
            if not essential[i]:
                di = lists[i][0]
                cursors[i] = int(np.searchsorted(di, d, side="left"))
        # local refinement, descending term order
        sb = sl = 0.0
        alive = True
        for i in range(nq - 1, -1, -1):
            if not essential[i]:
                if b * sb + (1 - b) * sl + prefix_beta[i] <= th_lo:
                    alive = False
                    break
            di, wbi, wli = lists[i]
            c = cursors[i]
            if c < len(di) and di[c] == d:
                sb += wbi[c]
                sl += wli[c]
        docs_evaluated += 1
        q_rk.push(g * sb + (1 - g) * sl, int(d))  # partial or full
        if alive:
            q_gl.push(a * sb + (1 - a) * sl, int(d))
            q_lo.push(b * sb + (1 - b) * sl, int(d))
        else:
            docs_frozen += 1
        # advance every cursor sitting at d
        for i in range(nq):
            di = lists[i][0]
            c = cursors[i]
            if c < len(di) and di[c] == d:
                cursors[i] = c + 1
    ids, vals = q_rk.sorted_desc()
    stats = {"docs_evaluated": docs_evaluated, "docs_frozen": docs_frozen}
    return ids, vals, stats
