"""Synthetic retrieval corpora with controllable BM25<->learned alignment.

No MS MARCO offline, so the evaluation reproduces the paper's *phenomena* on
generated data whose knobs mirror the real-model regimes:

- ``expansion_rate``: fraction of learned postings absent from the BM25 index
  (paper: SPLADE++ 98.6%, uniCOIL 1.4%, DeepImpact ~0 after T5 expansion).
- ``weight_noise``: decorrelation between BM25 and learned weights on shared
  postings (learned models re-weight, not just expand).
- planted relevance: each query has ``n_rel`` relevant docs whose *learned*
  weights on query terms are boosted; in misaligned regimes a share of that
  boost lands on expansion-only postings — exactly the mass BM25-guided
  pruning cannot see, which is what degrades GTI at small k.
- graded relevance (``n_rel_partial > 0``): a second tier of *partially*
  relevant docs is planted with roughly half the learned boost — grade 1
  next to the fully-relevant grade 2 — so graded metrics (nDCG) are
  non-degenerate. ``qrels`` stays the binary top-grade set (backward
  compatible); ``qrels_graded`` carries docid -> gain per query. With the
  default ``n_rel_partial=0`` the generator's rng draw sequence is
  unchanged, so seeded corpora are bit-identical to pre-graded builds.

Three presets mirror the paper's models: ``splade_like``, ``unicoil_like``,
``deepimpact_like``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.align import merge_models
from ..core.bm25 import Bm25Stats, build_bm25
from ..core.sparse import SparseModel, from_coo


@dataclasses.dataclass
class CorpusChunk:
    """One contiguous docid range of a corpus, as term-major COO postings.

    The unit ``repro_torch.data.StreamingIndexBuilder`` consumes: postings
    are sorted by (term, docid) with docids *chunk-local* (global docid =
    ``doc_start + docids[i]``). Chunks tile the docid space contiguously,
    so a chunk's tiles are a contiguous global tile range.
    """
    chunk_id: int
    doc_start: int
    n_docs: int
    terms: np.ndarray    # [nnz] int64 term ids, non-decreasing
    docids: np.ndarray   # [nnz] int32 chunk-local, sorted within term
    w_b: np.ndarray      # [nnz] f32
    w_l: np.ndarray      # [nnz] f32


@dataclasses.dataclass
class SyntheticCorpus:
    n_docs: int
    n_terms: int
    bm25: SparseModel
    bm25_stats: Bm25Stats
    learned: SparseModel
    queries: np.ndarray        # [Q, Nq] int32 term ids (padded with 0)
    q_weights_l: np.ndarray    # [Q, Nq] f32 learned query weights (0 = pad)
    q_weights_b: np.ndarray    # [Q, Nq] f32 BM25 query weights (0 = pad)
    qrels: list[set[int]]      # fully-relevant docids per query (binary)
    # graded judgments: docid -> gain (2.0 = relevant, 1.0 = partial);
    # equals {d: 2.0 for d in qrels[qi]} when n_rel_partial == 0
    qrels_graded: list[dict[int, float]] | None = None
    # the BM25-strong / learned-just-below distractors planted per query
    # (the docs inaccurate guidance promotes; the eval harness gives them
    # confusable dense signal so no single modality is trivially perfect)
    q_distractors: list[set[int]] | None = None

    def merged(self, fill: str = "scaled"):
        return merge_models(self.learned, self.bm25, fill,
                            bm25_stats=self.bm25_stats)

    def iter_chunks(self, chunk_docs: int, fill: str = "scaled"):
        """Yield the corpus as ``CorpusChunk``s of ``chunk_docs`` docs.

        Slices the *same* merged postings the one-shot builders consume,
        so streaming a seeded corpus chunk by chunk reproduces the one-shot
        index bit for bit. The last chunk may be short.
        """
        if chunk_docs < 1:
            raise ValueError(f"chunk_docs must be >= 1, got {chunk_docs}")
        merged = self.merged(fill)
        term_of = np.repeat(np.arange(self.n_terms, dtype=np.int64),
                            np.diff(merged.indptr))
        for cid, d0 in enumerate(range(0, self.n_docs, chunk_docs)):
            d1 = min(d0 + chunk_docs, self.n_docs)
            m = (merged.docids >= d0) & (merged.docids < d1)
            yield CorpusChunk(
                chunk_id=cid, doc_start=d0, n_docs=d1 - d0,
                terms=term_of[m],
                docids=(merged.docids[m] - d0).astype(np.int32),
                w_b=merged.w_b[m], w_l=merged.w_l[m])


PRESETS = {
    # expansion_rate, weight_noise, rel_mass_on_expansion
    "splade_like": (0.92, 0.55, 0.75),
    "unicoil_like": (0.05, 0.25, 0.10),
    "deepimpact_like": (0.15, 0.35, 0.25),
}


def make_corpus(preset: str = "splade_like", n_docs: int = 8192,
                n_terms: int = 2048, n_queries: int = 64, n_q_terms: int = 6,
                n_rel: int = 4, avg_doc_terms: int = 48,
                seed: int = 0, n_rel_partial: int = 0,
                rel_boost_scale: float = 1.0) -> SyntheticCorpus:
    """``rel_boost_scale`` multiplies the planted relevant/partial learned
    boosts (distractors are untouched): < 1 pushes the relevant band down
    into the distractor band, making the ranking genuinely contested —
    the regime the relevance harness needs. A pure multiply on already-
    drawn values, so the default (1.0) is bit-identical to older builds
    and any scale leaves the rng draw sequence unchanged."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; options {list(PRESETS)}")
    expansion_rate, weight_noise, rel_on_exp = PRESETS[preset]
    rng = np.random.default_rng(seed)

    # --- base lexical corpus: Zipf term frequencies ------------------------
    n_base = n_docs * avg_doc_terms
    zipf_p = 1.0 / np.arange(1, n_terms + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    terms = rng.choice(n_terms, size=n_base, p=zipf_p).astype(np.int64)
    docs = rng.integers(0, n_docs, size=n_base).astype(np.int64)
    # dedupe (term, doc); tf ~ 1 + geometric
    key = terms * n_docs + docs
    key = np.unique(key)
    terms = (key // n_docs).astype(np.int64)
    docs = (key % n_docs).astype(np.int64)
    tfs = 1 + rng.geometric(0.55, size=len(key))
    doc_lens = np.bincount(docs, weights=tfs, minlength=n_docs).astype(np.float32)
    doc_lens = np.maximum(doc_lens, 1.0)
    bm25, stats = build_bm25(n_docs, n_terms, terms, docs, tfs, doc_lens)

    # --- learned model: reweight shared postings + expansion postings ------
    base_l = bm25.weights * np.exp(
        rng.normal(0.0, weight_noise, size=bm25.nnz)).astype(np.float32)
    n_exp = int(expansion_rate / max(1e-9, 1 - expansion_rate) * bm25.nnz)
    exp_terms = rng.choice(n_terms, size=n_exp, p=zipf_p).astype(np.int64)
    exp_docs = rng.integers(0, n_docs, size=n_exp).astype(np.int64)
    exp_w = rng.gamma(1.5, 0.6, size=n_exp).astype(np.float32)
    rep_t = np.repeat(np.arange(n_terms, dtype=np.int64), np.diff(bm25.indptr))
    all_terms = np.concatenate([rep_t, exp_terms])
    all_docs = np.concatenate([bm25.docids.astype(np.int64), exp_docs])
    all_w = np.concatenate([base_l, exp_w])

    # --- queries, planted relevance, hard distractors ----------------------
    # Query terms from the mid-frequency band (informative but non-empty).
    band = np.arange(n_terms // 64, n_terms // 2)
    queries = np.zeros((n_queries, n_q_terms), dtype=np.int32)
    qrels: list[set[int]] = []
    qrels_graded: list[dict[int, float]] = []
    q_distractors: list[set[int]] = []
    boost_t, boost_d, boost_w = [], [], []   # learned-side boosts
    add_t, add_d, add_tf = [], [], []        # BM25-side tf boosts
    n_distract = 24
    for qi in range(n_queries):
        qt = rng.choice(band, size=n_q_terms, replace=False).astype(np.int32)
        queries[qi] = qt
        pool = rng.choice(n_docs, size=n_rel + n_rel_partial + n_distract,
                          replace=False)
        rel = pool[:n_rel]
        partial = pool[n_rel:n_rel + n_rel_partial]
        distract = pool[n_rel + n_rel_partial:]
        qrels.append(set(int(d) for d in rel))
        qrels_graded.append({**{int(d): 2.0 for d in rel},
                             **{int(d): 1.0 for d in partial}})
        q_distractors.append(set(int(d) for d in distract))
        for d in rel:
            # Relevant docs: strong learned weights on all query terms, but
            # only (1 - rel_on_exp) of the terms are BM25-visible, weakly.
            # At least one term stays visible (real docs contain their topic
            # words; expansion shifts mass, it doesn't erase the lexical core).
            visible = rng.random(n_q_terms) > rel_on_exp
            visible[rng.integers(0, n_q_terms)] = True
            for t, vis in zip(qt, visible):
                boost_t.append(int(t))
                boost_d.append(int(d))
                boost_w.append(rel_boost_scale
                               * float(rng.gamma(4.0, 1.0) + 4.0))
                if vis:
                    add_t.append(int(t))
                    add_d.append(int(d))
                    add_tf.append(int(rng.integers(1, 4)))
        for d in partial:
            # Partial tier (grade 1): roughly half the relevant boost on
            # the same visibility pattern. Lands between the relevant band
            # and the distractor band so graded metrics have real ordering
            # to measure. Draws happen only when n_rel_partial > 0, so the
            # default rng sequence is untouched.
            visible = rng.random(n_q_terms) > rel_on_exp
            visible[rng.integers(0, n_q_terms)] = True
            for t, vis in zip(qt, visible):
                boost_t.append(int(t))
                boost_d.append(int(d))
                boost_w.append(rel_boost_scale
                               * float(rng.gamma(3.0, 0.9) + 2.0))
                if vis:
                    add_t.append(int(t))
                    add_d.append(int(d))
                    add_tf.append(int(rng.integers(1, 3)))
        for d in distract:
            # Hard distractors: strong BM25 (high tf on most query terms),
            # learned scores just below the relevant band. These fill the
            # BM25-driven queues, so inaccurate guidance prunes the docs
            # that matter — the paper's small-k failure mode.
            for t in qt:
                if rng.random() < 0.7:
                    add_t.append(int(t))
                    add_d.append(int(d))
                    add_tf.append(int(rng.integers(2, 7)))
                boost_t.append(int(t))
                boost_d.append(int(d))
                boost_w.append(float(rng.gamma(3.0, 0.8) + 1.5))
    # planted postings FIRST: from_coo keeps the first duplicate, so boosts
    # override pre-existing base/expansion postings for the same (t, d).
    all_terms = np.concatenate([np.array(boost_t, np.int64), all_terms])
    all_docs = np.concatenate([np.array(boost_d, np.int64), all_docs])
    all_w = np.concatenate([np.array(boost_w, np.float32), all_w])
    learned = from_coo(n_docs, n_terms, all_terms, all_docs, all_w)

    if add_t:
        terms2 = np.concatenate([np.array(add_t, np.int64), terms])
        docs2 = np.concatenate([np.array(add_d, np.int64), docs])
        tfs2 = np.concatenate([np.array(add_tf, np.int64), tfs])
        doc_lens2 = np.bincount(docs2, weights=tfs2,
                                minlength=n_docs).astype(np.float32)
        doc_lens2 = np.maximum(doc_lens2, 1.0)
        bm25, stats = build_bm25(n_docs, n_terms, terms2, docs2, tfs2,
                                 doc_lens2)

    # Query weights: learned side weighted (impact-style), BM25 side 1.
    qw_l = (1.0 + rng.gamma(2.0, 0.5, size=queries.shape)).astype(np.float32)
    qw_b = np.ones_like(qw_l)
    return SyntheticCorpus(n_docs=n_docs, n_terms=n_terms, bm25=bm25,
                           bm25_stats=stats, learned=learned, queries=queries,
                           q_weights_l=qw_l, q_weights_b=qw_b, qrels=qrels,
                           qrels_graded=qrels_graded,
                           q_distractors=q_distractors)


def synthetic_chunk_stream(n_chunks: int, chunk_docs: int, n_terms: int,
                           avg_doc_terms: int = 32, seed: int = 0,
                           start_chunk: int = 0, zipf_a: float = 1.1):
    """A million-scale corpus as a resumable chunk stream.

    Each chunk is a pure function of ``(seed, chunk_id)`` (drawn from
    ``default_rng([seed, chunk_id])``), so a restarted build replays
    exactly the chunks it has not applied, with no upstream state to
    rewind. The corpus never exists whole: peak memory is one chunk.
    Postings follow ``make_corpus``'s lexical core (Zipf terms, geometric
    tf, log-normal learned reweighting) without queries or relevance.
    ``zipf_a`` sets the term-frequency skew.
    """
    zipf_p = 1.0 / np.arange(1, n_terms + 1) ** zipf_a
    zipf_p /= zipf_p.sum()
    for cid in range(start_chunk, n_chunks):
        rng = np.random.default_rng(np.random.SeedSequence([seed, cid]))
        n_base = chunk_docs * avg_doc_terms
        terms = rng.choice(n_terms, size=n_base, p=zipf_p).astype(np.int64)
        docs = rng.integers(0, chunk_docs, size=n_base).astype(np.int64)
        key = np.unique(terms * chunk_docs + docs)
        terms = (key // chunk_docs).astype(np.int64)
        docs = (key % chunk_docs).astype(np.int32)
        tf = (1 + rng.geometric(0.55, size=len(key))).astype(np.float32)
        w_b = (tf / (tf + 1.2)).astype(np.float32)
        w_l = (w_b * np.exp(rng.normal(0.0, 0.4, size=len(key)))
               ).astype(np.float32)
        yield CorpusChunk(chunk_id=cid, doc_start=cid * chunk_docs,
                          n_docs=chunk_docs, terms=terms, docids=docs,
                          w_b=w_b, w_l=w_l)
