"""Plain PyTorch reference of the benchmarked retrieval path.

It imports nothing of the program. From the generator's raw output (BM25
tfs and doc lengths, the learned postings) it works out the BM25 weights,
the scaled fill and the tile runs again, and replays 2GTI's chunked
traversal (``traversal="chunked_fused"``: chunk-start thresholds) for a
sample of the window's rows, each padded as its search padded it (term 0
at weight 0 up to the batch's longest query). Rows do not interact in the
program's chunk loop: a row whose chunk bound fails its threshold skips
every tile of that chunk, so a replay of a few rows gives what the whole
batch gave them.

Two numbers judge the program's ids and scores (``compare``):

- ``valid_gap``: the widest distance, over every returned entry, from its
  score to the nearest score 2GTI can give that doc: the gamma-combined sum
  over a suffix of the row's terms in planner order (a doc accumulates the
  essential terms, then non-essential ones in descending order until it
  freezes). Relative to the row's top reference score. A malformed row
  (an id out of range or repeated, scores not descending, another number
  of entries than the reference's) reads 1.
- ``rank_gap``: per row the widest rank-by-rank distance between the
  program's scores and the replay's, relative to the row's top score; the
  number is its largest over the sampled rows, so that one wrong row
  decides it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..roofline import live_postings

BM25_K1 = 0.9
BM25_B = 0.4


@dataclasses.dataclass
class Merged:
    """Union of both models' postings, sorted by key = term * n_docs +
    doc, with the aligned BM25 weight and the learned weight."""
    n_docs: int
    n_terms: int
    keys: torch.Tensor   # [nnz] int64, ascending
    w_b: torch.Tensor    # [nnz] float32
    w_l: torch.Tensor    # [nnz] float32


def merge(corpus, weight_dtype=torch.float32) -> Merged:
    """BM25 weights (float64, rounded to float32), the learned weights and
    the scaled fill of missing BM25 weights, ``mean(w_B) / mean(w_L) *
    w_L``. ``weight_dtype`` rounds the merged weights (the control's lower
    precision); the arithmetic stays in float32."""
    n_docs, n_terms = corpus.n_docs, corpus.n_terms
    df = torch.bincount(corpus.bm25_terms, minlength=n_terms).double()
    idf = torch.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    lens = corpus.doc_lens.double()
    tf = corpus.bm25_tfs.double()
    w_bm25 = (idf[corpus.bm25_terms] * tf * (BM25_K1 + 1.0)
              / (tf + BM25_K1 * (1.0 - BM25_B + BM25_B
                                 * lens[corpus.bm25_docs] / lens.mean())))
    w_bm25 = w_bm25.float()
    l_terms = torch.repeat_interleave(
        torch.arange(n_terms, device=corpus.l_docs.device),
        torch.diff(corpus.l_indptr))
    key_l = l_terms * n_docs + corpus.l_docs.long()
    key_b = corpus.bm25_terms * n_docs + corpus.bm25_docs
    keys = torch.unique(torch.cat([key_l, key_b]))
    w_l = torch.zeros(keys.numel(), dtype=torch.float32, device=keys.device)
    w_b = torch.zeros_like(w_l)
    w_l[torch.searchsorted(keys, key_l)] = corpus.l_weights
    pos_b = torch.searchsorted(keys, key_b)
    w_b[pos_b] = w_bm25
    in_b = torch.zeros_like(w_l, dtype=torch.bool)
    in_b[pos_b] = True
    pos_w = w_bm25 > 0
    ratio = (w_bm25[pos_w].double().mean()
             / corpus.l_weights[corpus.l_weights > 0].double().mean())
    fill = ~in_b & (w_l > 0)
    w_b[fill] = ratio.float() * w_l[fill]
    if weight_dtype != torch.float32:
        w_b = w_b.to(weight_dtype).float()
        w_l = w_l.to(weight_dtype).float()
    return Merged(n_docs, n_terms, keys, w_b, w_l)


def _seq_cumsum(x):
    """Prefix sums along the last dim, added left to right in float32."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def _combine(c: float, b, l):
    return c * b + (1.0 - c) * l


def _f32(x) -> float:
    return float(torch.tensor(float(x), dtype=torch.float32))


@dataclasses.dataclass
class Rows:
    """Rows of one padded width: terms and weights [R, W], and which slots
    hold a query's own terms (the rest pad the row to its batch's width)."""
    terms: torch.Tensor
    w_b: torch.Tensor
    w_l: torch.Tensor
    real: torch.Tensor    # [R, W] bool


def _runs(m: Merged, terms, tiles, tile_size: int):
    """Start and end (into ``m.keys``) of each term's postings in each
    tile: ``terms`` [..., W] and ``tiles`` [..., C] -> [..., C, W]."""
    base = terms[..., None, :] * m.n_docs + tiles[..., None] * tile_size
    start = torch.searchsorted(m.keys, base)
    end = torch.searchsorted(m.keys, base + tile_size)
    return start, end


def _tile_maxima(m: Merged, terms, n_tiles: int, tile_size: int):
    """Per (term, tile) maxima of both weights for ``terms`` [T]: [T,
    n_tiles] each, and per-term list maxima [T]."""
    tiles = torch.arange(n_tiles, device=terms.device)
    start, end = _runs(m, terms, tiles, tile_size)        # [n_tiles, T]
    start, end = start.T.contiguous(), end.T.contiguous()
    cnt = (end - start).flatten()
    run = torch.repeat_interleave(torch.arange(cnt.numel(),
                                               device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    pos = start.flatten()[run] + torch.arange(run.numel(),
                                              device=run.device) - first[run]
    out = []
    for w in (m.w_b, m.w_l):
        mx = torch.zeros(cnt.numel(), dtype=torch.float32, device=cnt.device)
        mx.scatter_reduce_(0, run, w[pos], "amax")
        out.append(mx.view(terms.numel(), n_tiles))
    return out[0], out[1], out[0].amax(-1), out[1].amax(-1)


@dataclasses.dataclass
class Schedule:
    """The planner's output for rows [R, W]: terms in planner order, their
    list bounds and prefix sums, each tile's alpha bound ``ub`` [R,
    n_tiles], and the tiles in descending bound order, padded to whole
    chunks with ``n_tiles`` (bound -inf)."""
    order: torch.Tensor          # [R, W] slot of each planner position
    qt: torch.Tensor             # [R, W] terms in planner order
    qwb: torch.Tensor
    qwl: torch.Tensor
    real: torch.Tensor           # [R, W] a query's own term, planner order
    ub: torch.Tensor             # [R, n_tiles]
    tile_order: torch.Tensor     # [R, n_chunks * chunk_tiles]
    chunk_ub: torch.Tensor       # [R, n_chunks]
    prefix_alpha: torch.Tensor   # [R, W]
    prefix_beta: torch.Tensor    # [R, W]
    n_tiles: int


def schedule(m: Merged, rows: Rows, params: dict, tile_size: int
             ) -> Schedule:
    """2GTI's planner over ``m`` for ``rows``: terms ascending by their
    alpha-combined list bound, per-tile bounds summed in that order, tiles
    in descending bound order (stable), folded into chunks of
    ``params["chunk_tiles"]``."""
    a, b = _f32(params["alpha"]), _f32(params["beta"])
    if params["bound_mode"] != "list":
        raise ValueError("the reference replays bound_mode='list' only")
    dev = rows.terms.device
    r_n, w_n = rows.terms.shape
    n_tiles = -(-m.n_docs // tile_size)
    uniq, inv = torch.unique(rows.terms, return_inverse=True)
    tmb_u, tml_u, sgb_u, sgl_u = _tile_maxima(m, uniq, n_tiles, tile_size)

    sig_b = rows.w_b * sgb_u[inv]
    sig_l = rows.w_l * sgl_u[inv]
    order = torch.argsort(_combine(a, sig_b, sig_l), dim=-1, stable=True)
    take = lambda x: torch.gather(x, -1, order)   # noqa: E731
    qt, qwb, qwl, sig_b, sig_l, qinv = (take(x) for x in (
        rows.terms, rows.w_b, rows.w_l, sig_b, sig_l, inv))
    tmb = qwb[..., None] * tmb_u[qinv]                  # [R, W, n_tiles]
    tml = qwl[..., None] * tml_u[qinv]
    comb = _combine(a, tmb, tml)
    ub = comb[:, 0]
    for j in range(1, w_n):
        ub = ub + comb[:, j]
    tile_order = torch.argsort(-ub, dim=-1, stable=True)
    ct = int(params["chunk_tiles"])
    n_chunks = -(-n_tiles // ct)
    pad = n_chunks * ct - n_tiles
    ub_sorted = torch.gather(ub, -1, tile_order)
    if pad:
        tile_order = torch.cat([tile_order, torch.full(
            (r_n, pad), n_tiles, device=dev, dtype=torch.long)], -1)
        ub_sorted = torch.cat([ub_sorted, torch.full(
            (r_n, pad), -math.inf, device=dev)], -1)
    return Schedule(
        order=order, qt=qt, qwb=qwb, qwl=qwl,
        real=take(rows.real),
        ub=ub, tile_order=tile_order,
        chunk_ub=ub_sorted.view(r_n, n_chunks, ct).amax(-1),
        prefix_alpha=_seq_cumsum(_combine(a, sig_b, sig_l)),
        prefix_beta=_seq_cumsum(_combine(b, sig_b, sig_l)),
        n_tiles=n_tiles)


def visit_order_runs(m: Merged, sched: Schedule, tile_size: int):
    """Postings of each (row, tile, term) run, tiles in the row's visit
    order and terms in planner order (``sched.real`` marks the query's
    own): [R, n_tiles, W] int64, as ``roofline.k1_counts`` reads them."""
    tiles = sched.tile_order[:, :sched.n_tiles]
    start, end = _runs(m, sched.qt, tiles, tile_size)
    return end - start


@dataclasses.dataclass
class Replay:
    ids: torch.Tensor       # [R, k] int64 (rank queue; -1 or any past the
    scores: torch.Tensor    # [R, k] float32   candidates: score -inf)
    tiles_visited: torch.Tensor    # [R]
    postings_touched: torch.Tensor  # [R] (``roofline.live_postings``)
    live_postings: torch.Tensor    # [R] the same, a query's own terms only
    order: torch.Tensor            # [R, W] the planner's term order


def replay(m: Merged, rows: Rows, params: dict, k: int, tile_size: int
           ) -> Replay:
    """2GTI over the tile-blocked postings of ``m`` for ``rows``, as the
    chunked traversal runs it: tiles in descending bound order, folded into
    chunks of ``params["chunk_tiles"]`` (``schedule``); each chunk scored
    against the thresholds at its start (skip when the tile's alpha bound
    is at most theta_Gl; essential terms by the alpha prefix; the
    descending freeze loop against theta_Lo with the beta prefix); top-k
    queues merged with a stable sort; stop at the first chunk no row can
    enter."""
    a, b, g = (_f32(params[x]) for x in ("alpha", "beta", "gamma"))
    dev = rows.terms.device
    r_n, w_n = rows.terms.shape
    sc = schedule(m, rows, params, tile_size)
    n_tiles, ct = sc.n_tiles, int(params["chunk_tiles"])
    qt, qwb, qwl = sc.qt, sc.qwb, sc.qwl
    prefix_alpha, prefix_beta = sc.prefix_alpha, sc.prefix_beta
    chunks = sc.tile_order.view(r_n, -1, ct)
    n_chunks = chunks.shape[1]
    chunk_ub = sc.chunk_ub
    ub_pad = torch.cat([sc.ub, torch.full((r_n, 1), -math.inf,
                                          device=dev)], -1)

    kq = min(k, tile_size)
    inf = torch.full((r_n, k), -math.inf, device=dev)
    none = torch.full((r_n, k), -1, dtype=torch.long, device=dev)
    queues = [[inf, none], [inf.clone(), none], [inf.clone(), none]]
    visited = torch.zeros(r_n, dtype=torch.long, device=dev)
    touched = torch.zeros(r_n, dtype=torch.long, device=dev)
    live = torch.zeros_like(touched)
    ar_s = torch.arange(tile_size, device=dev)
    for i in range(n_chunks):
        th_gl, th_lo = queues[0][0][:, -1], queues[1][0][:, -1]
        active = chunk_ub[:, i] > th_gl
        if not bool(active.any()):
            break
        tiles = chunks[:, i]                                  # [R, C]
        skip = (torch.gather(ub_pad, -1, tiles) <= th_gl[:, None]) \
            | (tiles >= n_tiles)
        ess = prefix_alpha > th_gl[:, None]                   # [R, W]
        start, end = _runs(m, qt, tiles, tile_size)           # [R, C, W]
        touched += live_postings(end - start, skip)
        live += live_postings((end - start) * sc.real[:, None], skip)
        cnt = torch.where(skip[..., None], 0, end - start)
        visited += (~skip).sum(-1)
        flat = cnt.flatten()
        run = torch.repeat_interleave(torch.arange(flat.numel(),
                                                   device=dev), flat)
        first = torch.cumsum(flat, 0) - flat
        pos = start.flatten()[run] + torch.arange(run.numel(),
                                                  device=dev) - first[run]
        rc = run // w_n                                       # (row, tile)
        slot = m.keys[pos] % m.n_docs - tiles.flatten()[rc] * tile_size
        cell = run * tile_size + slot
        size = (r_n, ct, w_n, tile_size)
        qb = qwb[:, None, :].expand(r_n, ct, w_n).flatten()[run]
        ql = qwl[:, None, :].expand(r_n, ct, w_n).flatten()[run]
        dense_b = torch.zeros(size, device=dev).view(-1)
        dense_l = torch.zeros(size, device=dev).view(-1)
        present = torch.zeros(size, dtype=torch.bool, device=dev).view(-1)
        dense_b[cell] = m.w_b[pos] * qb
        dense_l[cell] = m.w_l[pos] * ql
        present[cell] = True
        dense_b, dense_l, present = (x.view(size) for x in (
            dense_b, dense_l, present))
        survive = (present & ess[:, None, :, None]).any(-2)  # [R, C, S]
        sb = torch.zeros(r_n, ct, tile_size, device=dev)
        sl = torch.zeros_like(sb)
        alive = torch.ones_like(survive)
        for j in range(w_n - 1, -1, -1):
            l_part = b * sb + (1.0 - b) * sl
            ok = ess[:, None, j, None] | (
                l_part + prefix_beta[:, None, j, None] > th_lo[:, None, None])
            alive = alive & ok
            gate = (survive & alive).float()
            sb = sb + gate * dense_b[:, :, j]
            sl = sl + gate * dense_l[:, :, j]
        evals = survive & alive
        base = tiles[..., None] * tile_size
        for q, (c, mask) in enumerate(((a, evals), (b, evals),
                                       (g, survive))):
            vals = torch.where(mask, _combine(c, sb, sl), -math.inf)
            top, idx = torch.sort(vals, dim=-1, descending=True, stable=True)
            top = torch.where(skip[..., None], -math.inf, top[..., :kq])
            cand_ids = base + ar_s[idx[..., :kq]]
            qv = torch.cat([queues[q][0], top.flatten(1)], -1)
            qi = torch.cat([queues[q][1], cand_ids.flatten(1)], -1)
            qv, sel = torch.sort(qv, dim=-1, descending=True, stable=True)
            queues[q] = [qv[:, :k], torch.gather(qi, -1, sel[:, :k])]
    return Replay(ids=queues[2][1], scores=queues[2][0],
                  tiles_visited=visited, postings_touched=touched,
                  live_postings=live, order=sc.order)


def _lookup(m: Merged, terms, docs):
    """Weights of (term, doc) pairs (0 where absent): [..] each."""
    key = terms * m.n_docs + docs
    pos = torch.searchsorted(m.keys, key).clamp_(max=m.keys.numel() - 1)
    hit = m.keys[pos] == key
    return (torch.where(hit, m.w_b[pos], 0.0),
            torch.where(hit, m.w_l[pos], 0.0))


def compare(m: Merged, rows: Rows, ref: Replay, ids, scores,
            params: dict):
    """Per-row ``valid_gap`` and ``rank_gap`` (module docstring) of the
    program's ``ids`` [R, k] and ``scores`` [R, k] against the replay
    ``ref`` of the same ``rows``: two [R] tensors."""
    g = _f32(params["gamma"])
    ids = ids.to(ref.ids.device).long()
    scores = scores.to(ref.ids.device).float()
    r_n, k = ids.shape
    top = ref.scores[:, 0].double().clamp(min=1e-30)

    got_fin, ref_fin = torch.isfinite(scores), torch.isfinite(ref.scores)
    both = got_fin & ref_fin
    rank = torch.where(both, (scores.double() - ref.scores.double()).abs()
                       / top[:, None], 0.0)
    rank = torch.where(got_fin != ref_fin, 1.0, rank).amax(-1)

    # every finite entry against the suffix sums of its doc
    qt = torch.gather(rows.terms, -1, ref.order)
    qwb = torch.gather(rows.w_b, -1, ref.order)
    qwl = torch.gather(rows.w_l, -1, ref.order)
    docs = ids.clamp(0, m.n_docs - 1)
    wb, wl = _lookup(m, qt[:, None, :], docs[..., None])  # [R, k, W]
    contrib = (g * (wb * qwb[:, None]).double()
               + (1.0 - g) * (wl * qwl[:, None]).double())
    suffix = torch.flip(torch.cumsum(torch.flip(contrib, [-1]), -1), [-1])
    dist = (scores.double()[..., None] - suffix).abs().amin(-1) / top[:, None]
    valid = torch.where(got_fin, dist, 0.0).amax(-1)

    malformed = got_fin.sum(-1) != ref_fin.sum(-1)
    fin_scores = torch.where(got_fin, scores, -math.inf)
    malformed |= (fin_scores[:, 1:] > fin_scores[:, :-1]).any(-1)
    malformed |= (got_fin & ((ids < 0) | (ids >= m.n_docs))).any(-1)
    marked = torch.where(got_fin, ids, -1 - torch.arange(
        k, device=ids.device)[None])
    srt = torch.sort(marked, -1).values
    malformed |= ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(-1)
    return torch.where(malformed, 1.0, valid), rank


def numbers(valid, rank) -> dict:
    """The two compared numbers from per-row gaps of all sampled rows:
    each the largest over the rows."""
    return {"valid_gap": float(valid.max()), "rank_gap": float(rank.max())}
