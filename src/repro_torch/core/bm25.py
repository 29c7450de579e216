"""BM25 weighting (Robertson/Sparck-Jones) over term-frequency corpora.

The paper builds a BM25 index over DocT5Query-expanded documents, tokenized
to match the learned model. Here BM25 is computed from (tf, doclen, df)
statistics; ``one_fill_weight`` implements the paper's one-filling alignment
(Section 4.3): the BM25 weight a (term, doc) pair *would* have had with tf=1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sparse import SparseModel, from_coo

K1 = 0.9
B = 0.4


@dataclasses.dataclass
class Bm25Stats:
    """Corpus statistics needed to (re)compute BM25 weights."""

    n_docs: int
    n_terms: int
    doc_lens: np.ndarray  # [n_docs] float32
    idf: np.ndarray       # [n_terms] float32

    @property
    def avg_len(self) -> float:
        return float(self.doc_lens.mean())


def idf_from_df(n_docs: int, df: np.ndarray) -> np.ndarray:
    """Lucene-style non-negative idf."""
    return np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)


def bm25_weight(tf: np.ndarray, doc_len: np.ndarray, idf: np.ndarray,
                avg_len: float, k1: float = K1, b: float = B) -> np.ndarray:
    """w_B(t, d) = idf(t) * tf*(k1+1) / (tf + k1*(1 - b + b*len/avglen))."""
    denom = tf + k1 * (1.0 - b + b * doc_len / avg_len)
    return (idf * tf * (k1 + 1.0) / denom).astype(np.float32)


def one_fill_weight(doc_len: np.ndarray, idf: np.ndarray, avg_len: float,
                    k1: float = K1, b: float = B) -> np.ndarray:
    """BM25 weight with tf = 1 — the one-filling value for missing pairs."""
    return bm25_weight(np.ones_like(doc_len), doc_len, idf, avg_len, k1, b)


def build_bm25(n_docs: int, n_terms: int, terms: np.ndarray, docs: np.ndarray,
               tfs: np.ndarray, doc_lens: np.ndarray,
               k1: float = K1, b: float = B) -> tuple[SparseModel, Bm25Stats]:
    """BM25 SparseModel + stats from COO (term, doc, tf) triples."""
    df = np.bincount(terms, minlength=n_terms).astype(np.float32)
    idf = idf_from_df(n_docs, df)
    avg_len = float(doc_lens.mean())
    w = bm25_weight(tfs.astype(np.float32), doc_lens[docs].astype(np.float32),
                    idf[terms], avg_len, k1, b)
    model = from_coo(n_docs, n_terms, terms, docs, w)
    stats = Bm25Stats(n_docs, n_terms, doc_lens.astype(np.float32), idf)
    return model, stats
