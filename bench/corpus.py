"""Seeded learned-sparse corpora, generated on the card.

A frozen copy of the distributions of ``repro_torch.data.corpus.
make_corpus``, rewritten as a few large torch calls on one device, so that
a 2^20-doc corpus takes seconds instead of minutes of host time:

- a lexical core: ``n_docs * avg_doc_terms`` Zipf(``zipf_a``) term draws
  onto uniform docs, deduplicated per (term, doc), tf = 1 + Geometric(0.55);
- a learned model: BM25 weights of the core times LogNormal(0,
  ``weight_noise``), plus ``expansion_rate / (1 - expansion_rate)`` times
  as many expansion postings (Zipf terms, uniform docs, Gamma(1.5, 0.6));
- a pool of queries: lengths ``min`` plus a floored exponential of mean
  ``exp_mean``, clipped to ``max`` (the ``terms`` group), distinct terms
  from the mid-frequency band ``[n_terms // 64, n_terms // 2)``, learned
  weights 1 + Gamma(2, 0.5), BM25 weights 1;
- planted relevance per query: ``n_rel`` relevant docs with learned boosts
  Gamma(4, 1) + 4 on every query term, of which a share
  ``1 - rel_on_expansion`` (at least one) is BM25-visible with tf 1-3; and
  ``n_distract`` BM25-strong distractors (tf 2-6 on each term with
  probability 0.7) with learned boosts Gamma(3, 0.8) + 1.5.

Planted postings come first and win over drawn ones for the same (term,
doc), as in ``make_corpus``. Unlike it, documents of one query's pool are
drawn with replacement (a repeat is merged), and the BM25 doc lengths are
the tf sums of the deduplicated postings. The same seed gives the same
corpus on the same device type.
"""
from __future__ import annotations

import dataclasses

import torch

BM25_K1 = 0.9
BM25_B = 0.4


@dataclasses.dataclass
class Corpus:
    """Term-major postings of both models and the query pool, on one
    device."""
    n_docs: int
    n_terms: int
    bm25_terms: torch.Tensor    # [n_b] int64, sorted by (term, doc)
    bm25_docs: torch.Tensor     # [n_b] int64
    bm25_tfs: torch.Tensor      # [n_b] float32
    doc_lens: torch.Tensor      # [n_docs] float32 (tf sums, at least 1)
    l_indptr: torch.Tensor      # [n_terms + 1] int64
    l_docs: torch.Tensor        # [n_l] int32, sorted within each term
    l_weights: torch.Tensor     # [n_l] float32
    q_terms: torch.Tensor       # [Q, max_len] int64 (0 past q_lens)
    q_lens: torch.Tensor        # [Q] int64
    q_weights_l: torch.Tensor   # [Q, max_len] float32 (0 past q_lens)


def bm25_weights(tfs, doc_len, df, n_docs: int, avg_len):
    """w_B = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len / avglen)),
    idf = log(1 + (N - df + 0.5) / (df + 0.5)), in the tensors' dtype."""
    idf = torch.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    denom = tfs + BM25_K1 * (1.0 - BM25_B + BM25_B * doc_len / avg_len)
    return idf * tfs * (BM25_K1 + 1.0) / denom


def _zipf(n: int, n_terms: int, a: float, gen, device):
    p = torch.arange(1, n_terms + 1, dtype=torch.float64,
                     device=device) ** -a
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=n_terms - 1)


def _gamma(shape, conc: float, gen, device):
    return torch._standard_gamma(
        torch.full(shape, conc, dtype=torch.float32, device=device),
        generator=gen)


def _dedupe_first(keys, *values):
    """Sort by ``keys`` (stable) and keep the first entry of each key."""
    keys, order = torch.sort(keys, stable=True)
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    return (keys[keep],) + tuple(v[order][keep] for v in values)


def make_corpus(cfg: dict, seed: int, device) -> Corpus:
    """The corpus of configuration ``cfg`` (``n_docs``, ``n_terms`` and its
    ``corpus`` and ``queries`` groups) from ``seed``, on ``device``."""
    c, q = cfg["corpus"], cfg["queries"]
    n_docs, n_terms = int(cfg["n_docs"]), int(cfg["n_terms"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dev = torch.device(device)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    # lexical core
    n_base = n_docs * int(c["avg_doc_terms"])
    keys = _zipf(n_base, n_terms, c["zipf_a"], gen, dev) * n_docs \
        + randint(n_docs, (n_base,))
    keys = torch.unique(keys)
    tfs = 1.0 + torch.empty(keys.numel(), device=dev).geometric_(
        0.55, generator=gen)
    terms, docs = keys // n_docs, keys % n_docs
    doc_len0 = torch.bincount(docs, tfs, minlength=n_docs).clamp_(min=1.0)
    df0 = torch.bincount(terms, minlength=n_terms).float()
    w0 = bm25_weights(tfs, doc_len0[docs], df0[terms], n_docs,
                      doc_len0.mean())
    base_l = w0 * torch.exp(c["weight_noise"] * torch.randn(
        keys.numel(), generator=gen, device=dev))

    # expansion postings
    r = float(c["expansion_rate"])
    n_exp = int(r / max(1e-9, 1.0 - r) * keys.numel())
    exp_keys = _zipf(n_exp, n_terms, c["zipf_a"], gen, dev) * n_docs \
        + randint(n_docs, (n_exp,))
    exp_w = 0.6 * _gamma((n_exp,), 1.5, gen, dev)

    # query pool
    n_q, lo, hi = int(q["n"]), int(q["terms"]["min"]), int(q["terms"]["max"])
    lens = lo + torch.empty(n_q, device=dev).exponential_(
        1.0 / q["terms"]["exp_mean"], generator=gen).floor_().long()
    lens = lens.clamp_(max=hi)
    band_lo, band_hi = n_terms // 64, n_terms // 2
    q_terms = band_lo + rand((n_q, band_hi - band_lo)).topk(hi, -1).indices
    live = torch.arange(hi, device=dev)[None] < lens[:, None]
    q_terms = torch.where(live, q_terms, 0)
    qw_l = torch.where(live, 1.0 + 0.5 * _gamma((n_q, hi), 2.0, gen, dev),
                       0.0)

    # planted relevance: [Q, n, hi] per query term
    n_rel, n_dis = int(q["n_rel"]), int(q["n_distract"])
    rel_docs = randint(n_docs, (n_q, n_rel))
    dis_docs = randint(n_docs, (n_q, n_dis))
    rel_w = 4.0 + _gamma((n_q, n_rel, hi), 4.0, gen, dev)
    visible = rand((n_q, n_rel, hi)) > c["rel_on_expansion"]
    forced = (rand((n_q, n_rel)) * lens[:, None]).long()
    visible.scatter_(-1, forced[..., None], True)
    rel_tf = randint(3, (n_q, n_rel, hi)) + 1.0
    dis_add = rand((n_q, n_dis, hi)) < 0.7
    dis_tf = randint(5, (n_q, n_dis, hi)) + 2.0
    dis_w = 1.5 + 0.8 * _gamma((n_q, n_dis, hi), 3.0, gen, dev)

    def planted(docs_, mask):
        k = q_terms[:, None, :] * n_docs + docs_[..., None]
        return k[mask & live[:, None, :]]

    l_keys = torch.cat([planted(rel_docs, live[:, None].expand_as(rel_w)),
                        planted(dis_docs, live[:, None].expand_as(dis_w)),
                        keys, exp_keys])
    l_w = torch.cat([rel_w[live[:, None].expand_as(rel_w)],
                     dis_w[live[:, None].expand_as(dis_w)], base_l, exp_w])
    l_keys, l_w = _dedupe_first(l_keys, l_w)
    l_terms = l_keys // n_docs
    l_indptr = torch.zeros(n_terms + 1, dtype=torch.int64, device=dev)
    l_indptr[1:] = torch.cumsum(torch.bincount(l_terms, minlength=n_terms),
                                0)

    vis = visible & live[:, None]
    dis = dis_add & live[:, None]
    b_keys = torch.cat([planted(rel_docs, vis), planted(dis_docs, dis),
                        keys])
    b_tfs = torch.cat([rel_tf[vis], dis_tf[dis], tfs])
    b_keys, b_tfs = _dedupe_first(b_keys, b_tfs)
    b_docs = b_keys % n_docs
    doc_lens = torch.bincount(b_docs, b_tfs, minlength=n_docs).clamp_(
        min=1.0)
    return Corpus(n_docs=n_docs, n_terms=n_terms, bm25_terms=b_keys // n_docs,
                  bm25_docs=b_docs, bm25_tfs=b_tfs, doc_lens=doc_lens,
                  l_indptr=l_indptr, l_docs=(l_keys % n_docs).int(),
                  l_weights=l_w.float(), q_terms=q_terms, q_lens=lens,
                  q_weights_l=qw_l)
