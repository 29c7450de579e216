"""Hybrid sparse+dense retrieval substrate: index pair, query embedding,
dense rerank, and reciprocal-rank fusion.

The paper's relevance/efficiency argument only becomes measurable when a
second ranking signal exists: both related systems (BM25 -> dense-rerank
cascades; sparse+dense RRF fusion) dominate either modality alone on
judged corpora. This module supplies the shared substrate the ``cascade``
and ``rrf`` registry engines are built on:

- :class:`HybridIndex`: a sparse index (``core.index.BlockedImpactIndex``
  or ``index.CompressedImpactIndex``) paired with a
  :class:`~repro_torch.core.dense_guided.DenseGuidedIndex` over
  per-document embeddings in **original-docid order** (row ``d`` of the
  embedding matrix is document ``d``, so the sparse engines' orig-mapped
  result ids index the embedding table directly), plus a ``q_proj``
  [n_terms, D] term-projection matrix;
- :func:`embed_queries`: the sparse->dense query bridge: a query's
  embedding is the learned-weight-weighted sum of its terms' projection
  rows, L2-normalized and rotated into the dense index's PCA basis.
  Callers with real query embeddings pass them via ``SearchRequest.dense``;
- :func:`rerank_candidates`: cascade stage two: gather the candidates'
  embedding rows and take the exact-dense top-k;
- :func:`dense_topk`: batched exact dense ranking (the RRF dense leg);
- :func:`rrf_fuse`: reciprocal-rank fusion ``sum 1/(rrf_k + rank)`` with
  deterministic (score-desc, docid-asc) tie-breaks, on the host.

The dense stages run on the index's device and return numpy, as the sparse
engines do. Top-k selection keeps the reference's tie rule (lower index
first).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dense_guided import (DenseGuidedIndex, _check_full_f32,
                                 build_dense_index)
from ..core.index import BlockedImpactIndex, resolve_device
from ..core.traversal import _as_tensor, _topk_stable
from ..index.compressed import CompressedImpactIndex


@dataclasses.dataclass
class HybridIndex:
    """One corpus, two rankers: the sparse index plus a dense index whose
    embedding rows are **original-docid indexed** (row ``d`` embeds doc
    ``d``, because sparse engine results arrive orig-mapped).

    ``q_proj`` [n_terms, D] turns a sparse query into a dense one
    (:func:`embed_queries`); real deployments would plug a query encoder
    here, the synthetic harness plants a projection that is consistent
    with the generated document embeddings.
    """
    sparse: BlockedImpactIndex | CompressedImpactIndex
    dense: DenseGuidedIndex
    q_proj: torch.Tensor       # [n_terms, D] float32

    @property
    def n_docs(self) -> int:
        return self.sparse.n_docs

    @property
    def dim(self) -> int:
        return int(self.q_proj.shape[1])

    @property
    def device(self) -> torch.device:
        return self.dense.device

    def nbytes(self) -> dict:
        """Bytes on the device, by side, and their total."""
        sparse = self.sparse.nbytes()
        out = {"sparse": sparse if isinstance(sparse, int)
               else sparse["total"],
               "dense": self.dense.nbytes(),
               "q_proj": self.q_proj.numel() * self.q_proj.element_size()}
        out["total"] = sum(out.values())
        return out

    def to(self, device) -> "HybridIndex":
        """This index with every side on ``device`` (self when already
        there)."""
        dev = resolve_device(device)
        sparse, dense = self.sparse.to(dev), self.dense.to(dev)
        if sparse is self.sparse and dense is self.dense:
            return self
        return HybridIndex(sparse=sparse, dense=dense,
                           q_proj=self.q_proj.to(dev))


def build_hybrid_index(sparse, doc_emb, q_proj, block_size: int = 512,
                       d_cheap: int | None = None,
                       device="cuda") -> HybridIndex:
    """Pair a built sparse index (fp32 or compressed; moved to ``device``)
    with document embeddings (original-docid order) and a query
    projection. The dense side goes through
    ``core.dense_guided.build_dense_index``: PCA rotation preserves dot
    products and row order, so orig docids keep indexing rows."""
    dev = resolve_device(device)
    sparse = sparse.to(dev)
    doc_emb = _as_tensor(doc_emb, torch.float32, dev)
    q_proj = _as_tensor(q_proj, torch.float32, dev)
    if doc_emb.ndim != 2 or doc_emb.shape[0] != sparse.n_docs:
        raise ValueError(
            f"doc_emb must be [n_docs={sparse.n_docs}, D] in original "
            f"docid order, got shape {tuple(doc_emb.shape)}")
    if tuple(q_proj.shape) != (sparse.n_terms, doc_emb.shape[1]):
        raise ValueError(
            f"q_proj must be [n_terms={sparse.n_terms}, "
            f"D={doc_emb.shape[1]}], got {tuple(q_proj.shape)}")
    if d_cheap is None:
        d_cheap = min(16, int(doc_emb.shape[1]))
    dense = build_dense_index(doc_emb,
                              block_size=min(block_size, sparse.n_docs),
                              d_cheap=d_cheap, device=dev)
    return HybridIndex(sparse=sparse, dense=dense, q_proj=q_proj)


def embed_queries(hybrid: HybridIndex, terms, weights_l,
                  dense=None) -> torch.Tensor:
    """[B, D] query embeddings in the dense index's rotated basis, on the
    index's device.

    ``dense`` (optional, [B, D]): caller-provided raw query embeddings
    (e.g. a real query encoder), rotated here; otherwise the sparse query
    is bridged through ``q_proj`` weighted by the learned query weights
    (the side the rank score is dominated by)."""
    dev = hybrid.device
    _check_full_f32(dev)
    if dense is not None:
        q = _as_tensor(dense, torch.float32, dev)
        if q.ndim != 2 or q.shape[1] != hybrid.dim:
            raise ValueError(f"dense query embeddings must be [B, "
                             f"{hybrid.dim}], got {tuple(q.shape)}")
        return q @ hybrid.dense.rotation
    terms = _as_tensor(terms, torch.int64, dev)
    wl = _as_tensor(weights_l, torch.float32, dev)
    # zero-weight padding terms contribute nothing; the norm guard keeps
    # an all-padding (no-op) query at the zero vector
    e = (hybrid.q_proj[terms] * wl[..., None]).sum(-2)           # [B, D]
    n = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return (e / torch.clamp(n, min=1e-9)) @ hybrid.dense.rotation


def rerank_candidates(hybrid: HybridIndex, q_rot, cand_ids,
                      k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact-dense rerank of first-stage candidates [B, depth]: gather the
    candidates' embedding rows, score against the rotated queries, keep the
    top ``min(k, depth)``. Sentinel candidates (-1) never resurface; short
    rows pad with (-1, -inf). Equal scores keep the first stage's order."""
    dev = hybrid.device
    _check_full_f32(dev)
    cand = _as_tensor(cand_ids, torch.int64, dev)
    q_rot = _as_tensor(q_rot, torch.float32, dev)
    k = min(int(k), int(cand.shape[1]))
    ce = hybrid.dense.emb[cand.clamp(min=0)]               # [B, depth, D]
    s = torch.einsum("bkd,bd->bk", ce, q_rot)
    s = torch.where(cand >= 0, s, -torch.inf)
    vals, idx = _topk_stable(s, k)
    ids = torch.gather(cand, 1, idx)
    ids = torch.where(torch.isneginf(vals), -1, ids)
    return (vals.cpu().numpy().astype(np.float32),
            ids.to(torch.int32).cpu().numpy())


def dense_topk(hybrid: HybridIndex, q_rot,
               k: int) -> tuple[np.ndarray, np.ndarray]:
    """Batched exact dense top-k over the whole corpus, the zero pad rows
    masked (the RRF dense leg / the dense-only evaluation lane)."""
    dev = hybrid.device
    _check_full_f32(dev)
    k = min(int(k), hybrid.n_docs)
    emb = hybrid.dense.emb
    s = _as_tensor(q_rot, torch.float32, dev) @ emb.T      # [B, N_padded]
    s[:, hybrid.n_docs:] = -torch.inf                      # pad rows
    vals, ids = _topk_stable(s, k)
    return (vals.cpu().numpy().astype(np.float32),
            ids.to(torch.int32).cpu().numpy())


def rrf_fuse(ids_a: np.ndarray, ids_b: np.ndarray, k: int,
             rrf_k: float = 60.0) -> tuple[np.ndarray, np.ndarray]:
    """Reciprocal-rank fusion of two ranked id lists (per row):
    ``score(d) = sum over lists 1 / (rrf_k + rank_d)`` with 1-based
    ranks; docs absent from a list contribute nothing. Ties break
    deterministically by (fused score desc, docid asc). Sentinel ids
    (< 0) are skipped; rows with fewer than ``k`` fused docs pad with
    (-1, -inf)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    if ids_a.shape[0] != ids_b.shape[0]:
        raise ValueError(f"row mismatch: {ids_a.shape[0]} vs "
                         f"{ids_b.shape[0]} queries")
    b = ids_a.shape[0]
    out_ids = np.full((b, k), -1, np.int32)
    out_scores = np.full((b, k), -np.inf, np.float32)
    for row in range(b):
        fused: dict[int, float] = {}
        for ranked in (ids_a[row], ids_b[row]):
            for rank, d in enumerate(ranked, start=1):
                d = int(d)
                if d < 0:
                    continue
                fused[d] = fused.get(d, 0.0) + 1.0 / (rrf_k + rank)
        if not fused:
            continue
        docs = np.fromiter(fused.keys(), np.int64, len(fused))
        vals = np.fromiter(fused.values(), np.float64, len(fused))
        order = np.lexsort((docs, -vals))[:k]
        out_ids[row, :len(order)] = docs[order]
        out_scores[row, :len(order)] = vals[order]
    return out_ids, out_scores
