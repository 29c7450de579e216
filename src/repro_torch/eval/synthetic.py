"""Synthetic graded-qrels corpora with a planted dense modality.

``repro_torch.data.make_corpus`` already plants relevance into the *sparse*
impact weights (and, with ``n_rel_partial``, a grade-1 tier); this
module adds the second modality the hybrid engines need: per-document
embeddings plus a ``q_proj`` term-projection such that

- a query's embedding (learned-weight-weighted sum of its terms'
  projection rows, L2-normalized — exactly what
  ``repro_torch.retrieval.hybrid.embed_queries`` computes at query time) has
  planted cosine affinity to its relevant docs, scaled by grade;
- the BM25-strong distractors get a *weaker but nonzero* affinity, so
  the dense ranking is good-but-imperfect — neither modality alone is
  trivially right, which is what makes cascade/RRF measurable instead
  of degenerate;
- every other document is isotropic noise.

Everything is seed-pinned: two calls with the same arguments produce
bit-identical corpora, embeddings, and qrels, and they are bit-identical
to the JAX package's ``repro.eval.synthetic`` (the same numpy draws).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.index import BlockedImpactIndex, build_index
from ..data import make_corpus
from ..data.corpus import SyntheticCorpus
from ..retrieval.hybrid import HybridIndex, build_hybrid_index


@dataclasses.dataclass
class GradedCorpus:
    """A synthetic corpus plus its graded judgments and dense modality."""
    corpus: SyntheticCorpus
    qrels: list[dict[int, float]]    # per query: docid -> gain
    doc_emb: np.ndarray              # [n_docs, D] original-docid order
    q_proj: np.ndarray               # [n_terms, D] query-term projection

    @property
    def binary_qrels(self) -> list[set[int]]:
        """Any positive gain counts as relevant (MRR / recall view)."""
        return [set(g) for g in self.qrels]

    def queries(self) -> dict:
        """The sparse query batch as ``Retriever.search`` kwargs."""
        c = self.corpus
        return dict(terms=c.queries, weights_b=c.q_weights_b,
                    weights_l=c.q_weights_l)


def _embed_queries_np(q_proj: np.ndarray, terms: np.ndarray,
                      weights_l: np.ndarray) -> np.ndarray:
    """Host-side twin of ``hybrid.embed_queries`` (pre-rotation): the
    planting below must target the exact vectors the engines will
    compute at query time."""
    e = (q_proj[terms] * weights_l[..., None]).sum(axis=-2)
    n = np.linalg.norm(e, axis=-1, keepdims=True)
    return e / np.maximum(n, 1e-9)


def make_graded_corpus(preset: str = "splade_like", *, n_docs: int = 4096,
                       n_terms: int = 1024, n_queries: int = 32,
                       n_q_terms: int = 6, n_rel: int = 1,
                       n_rel_partial: int = 3, avg_doc_terms: int = 48,
                       dim: int = 32, seed: int = 0,
                       rel_boost_scale: float = 1.0,
                       rel_affinity: float = 1.0,
                       distract_affinity: float = 0.25,
                       noise: float = 1.0) -> GradedCorpus:
    """Generate a corpus with graded sparse relevance *and* a consistent
    planted dense modality.

    ``rel_affinity`` scales the grade-proportional pull of relevant docs
    toward their query's embedding; ``distract_affinity`` the (weaker)
    pull of the planted BM25-strong distractors — set it to 0 for a
    clean-separation corpus where dense alone is near-perfect.

    The defaults are deliberately *contested*: ``n_rel=1`` keeps MRR@10
    unsaturated (one prunable target per query instead of four chances),
    and ``rel_affinity=1.0`` puts relevant docs' dense cosine (~0.7)
    within reach of the corpus-wide noise tail, so dense-alone over the
    full corpus is good-but-imperfect while an exact rerank of a ~100-doc
    sparse candidate set (whose noise tail is far smaller) is near-exact —
    the cascade's advantage is structural, not planted."""
    corpus = make_corpus(preset, n_docs=n_docs, n_terms=n_terms,
                         n_queries=n_queries, n_q_terms=n_q_terms,
                         n_rel=n_rel, avg_doc_terms=avg_doc_terms,
                         seed=seed, n_rel_partial=n_rel_partial,
                         rel_boost_scale=rel_boost_scale)
    # independent stream: embedding draws must not perturb (or depend on
    # draw-order details of) the sparse corpus generator
    rng = np.random.default_rng(seed + 104729)
    q_proj = (rng.standard_normal((n_terms, dim)) / np.sqrt(dim)
              ).astype(np.float32)
    q_emb = _embed_queries_np(q_proj, corpus.queries, corpus.q_weights_l)
    doc_emb = (rng.standard_normal((n_docs, dim)) * noise / np.sqrt(dim)
               ).astype(np.float32)
    gmax = max((max(g.values()) for g in corpus.qrels_graded if g),
               default=1.0)
    for qi, gains in enumerate(corpus.qrels_graded):
        for d, g in gains.items():
            doc_emb[d] += rel_affinity * (g / gmax) * q_emb[qi]
        for d in corpus.q_distractors[qi]:
            doc_emb[d] += distract_affinity * q_emb[qi]
    doc_emb /= np.maximum(
        np.linalg.norm(doc_emb, axis=1, keepdims=True), 1e-9)
    return GradedCorpus(corpus=corpus, qrels=corpus.qrels_graded,
                        doc_emb=doc_emb, q_proj=q_proj)


def build_hybrid(graded: GradedCorpus, tile_size: int = 128,
                 fill: str = "scaled", block_size: int = 512,
                 d_cheap: int | None = None,
                 sparse_index: BlockedImpactIndex | None = None,
                 device="cuda") -> HybridIndex:
    """BII + dense index + query bridge for one graded corpus, on
    ``device``: the index every quality-bench engine lane opens on. Pass
    a prebuilt ``sparse_index`` (fp32 or compressed) to reuse an existing
    index (it must come from the same corpus)."""
    if sparse_index is None:
        sparse_index = build_index(graded.corpus.merged(fill),
                                   tile_size=tile_size, device=device)
    return build_hybrid_index(sparse_index, graded.doc_emb, graded.q_proj,
                              block_size=block_size, d_cheap=d_cheap,
                              device=device)
