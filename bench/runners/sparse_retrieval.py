"""Learned-sparse retrieval through ``repro_torch``'s ``Retriever``.

Set-up makes the configuration's corpus on the card from the seed
(``bench.corpus``), moves its raw postings to the host and builds the index
with the program's own steps: ``core.bm25.build_bm25``,
``core.align.merge_models`` (the configuration's fill) and
``core.index.build_index`` onto the card. The window then sends one search
after another (a closed loop, one client): each a batch of ``batch`` pool
queries, drawn without replacement in an order reshuffled every pass, with
the learned-side weights of each query scaled by a fresh factor from
``weight_scale``. Every draw follows from the seed and the search's
number, so the check regenerates any search's inputs.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import corpus as gen
from ..reference import twogti
from ..roofline import k1_counts


class Traffic:
    """The searches of one run: pool query ids and learned-weight scales
    from ``(seed, search number)``; warm-up searches from a stream of
    their own."""

    def __init__(self, pool, traffic: dict, seed: int):
        self.terms, self.w_l = pool          # per query: int32, float32
        self.n = len(self.terms)
        self.batch = int(traffic["batch"])
        self.lo, self.hi = traffic["weight_scale"]
        self.seed = int(seed)
        self._perm = {}

    def _pass(self, p: int) -> np.ndarray:
        if p not in self._perm:
            self._perm[p] = np.random.default_rng(
                [self.seed, 0, p]).permutation(self.n)
        return self._perm[p]

    def qids(self, i: int) -> np.ndarray:
        pos = np.arange(i * self.batch, (i + 1) * self.batch)
        passes = pos // self.n
        return np.array([self._pass(int(p))[int(s)] for p, s in
                         zip(passes, pos % self.n)], dtype=np.int64)

    def search(self, i: int, warmup: bool = False) -> dict:
        """Search ``i``'s inputs: ragged per-query lists, as a caller with
        queries of their own lengths sends them."""
        if warmup:
            rng = np.random.default_rng([self.seed, 2, i])
            qids = rng.choice(self.n, self.batch, replace=False)
        else:
            rng = np.random.default_rng([self.seed, 1, i])
            qids = self.qids(i)
        scale = rng.uniform(self.lo, self.hi, self.batch).astype(np.float32)
        terms = [self.terms[q] for q in qids]
        return {"terms": terms,
                "weights_b": [np.ones(len(t), np.float32) for t in terms],
                "weights_l": [self.w_l[q] * s for q, s in zip(qids, scale)]}


def _pool(c: gen.Corpus):
    terms = c.q_terms.cpu().numpy().astype(np.int32)
    w_l = c.q_weights_l.cpu().numpy()
    lens = c.q_lens.cpu().numpy()
    return ([terms[q, :lens[q]] for q in range(len(lens))],
            [w_l[q, :lens[q]] for q in range(len(lens))])


def _rows(picked, device) -> list[tuple[list, twogti.Rows]]:
    """Group (search number, inputs, row) triples by their search's padded
    width: ``[(triples, Rows)]``, each row padded by term 0 at weight 0 to
    that width, as the facade pads it."""
    groups = {}
    for i, inputs, r in picked:
        width = max(len(t) for t in inputs["terms"])
        groups.setdefault(width, []).append((i, inputs, r))
    out = []
    for width, pairs in sorted(groups.items()):
        t = np.zeros((len(pairs), width), np.int64)
        wb = np.zeros((len(pairs), width), np.float32)
        wl = np.zeros((len(pairs), width), np.float32)
        real = np.zeros((len(pairs), width), bool)
        for j, (_, inputs, r) in enumerate(pairs):
            n = len(inputs["terms"][r])
            t[j, :n] = inputs["terms"][r]
            wb[j, :n] = inputs["weights_b"][r]
            wl[j, :n] = inputs["weights_l"][r]
            real[j, :n] = True
        out.append((pairs, twogti.Rows(
            *(torch.from_numpy(x).to(device) for x in (t, wb, wl, real)))))
    return out


class Cell:
    """One cell of this kind: a configuration under a traffic mix."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.k = int(traffic["k"])
        self.timings = {}
        # search number -> ids, scores, tiles visited, postings touched
        # (the program's answers and counters, per row)
        self.results = {}

    # -- set-up ---------------------------------------------------------
    def build(self) -> None:
        from repro_torch.core import build_bm25, build_index, merge_models
        from repro_torch.core.sparse import SparseModel
        from repro_torch.core import twolevel
        from repro_torch.retrieval import Retriever
        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        c = gen.make_corpus(cfg, self.seed, dev)
        self.n_docs, self.n_terms = c.n_docs, c.n_terms
        self.traffic_gen = Traffic(_pool(c), self.traffic, self.seed)
        host = {f: getattr(c, f).cpu().numpy() for f in (
            "bm25_terms", "bm25_docs", "bm25_tfs", "doc_lens", "l_indptr",
            "l_docs", "l_weights")}
        del c
        gc.collect()
        self._sync()
        t1 = time.perf_counter()
        mem0 = self._allocated()
        bm25, stats = build_bm25(self.n_docs, self.n_terms,
                                 host["bm25_terms"], host["bm25_docs"],
                                 host["bm25_tfs"], host["doc_lens"])
        learned = SparseModel(self.n_docs, self.n_terms, host["l_indptr"],
                              host["l_docs"], host["l_weights"])
        t2 = time.perf_counter()
        merged = merge_models(learned, bm25, cfg["index"]["fill"],
                              bm25_stats=stats)
        del learned, bm25, stats, host
        t3 = time.perf_counter()
        self.index = build_index(merged, tile_size=cfg["index"]["tile_size"],
                                 device=dev)
        del merged
        gc.collect()
        self._sync()
        t4 = time.perf_counter()
        self.index_bytes = self._allocated() - mem0
        p = cfg["pruning"]
        params = getattr(twolevel, p["preset"])()
        for key in ("alpha", "beta", "gamma", "bound_mode", "schedule",
                    "chunk_tiles"):
            if getattr(params, key) != p[key]:
                raise ValueError(f"preset {p['preset']!r} has {key}="
                                 f"{getattr(params, key)!r}, the "
                                 f"configuration states {p[key]!r}")
        e = cfg["engine"]
        self.retriever = Retriever.open(
            self.index, params, engine=e["name"], traversal=e["traversal"],
            k_buckets=e["k_buckets"], device=dev)
        self.timings = {"generate_s": t1 - t0, "bm25_s": t2 - t1,
                        "merge_s": t3 - t2, "layout_upload_s": t4 - t3}

    def adopt(self, other: "Cell") -> None:
        """Serve from ``other``'s index (same configuration and seed)
        under this cell's traffic, without building it again."""
        for f in ("n_docs", "n_terms", "index", "index_bytes", "retriever",
                  "timings"):
            setattr(self, f, getattr(other, f))
        t = other.traffic_gen
        self.traffic_gen = Traffic((t.terms, t.w_l), self.traffic, self.seed)

    def warmup(self) -> None:
        """Searches of the traffic's own shape (batch, k, padded width)
        from the warm-up stream, outside the window."""
        for j in range(int(self.traffic["warmup_searches"])):
            self._search(self.inputs(j, warmup=True))

    # -- the window -----------------------------------------------------
    def inputs(self, i: int, warmup: bool = False) -> dict:
        return self.traffic_gen.search(i, warmup)

    def _search(self, x: dict):
        return self.retriever.search(terms=x["terms"],
                                     weights_b=x["weights_b"],
                                     weights_l=x["weights_l"], k=self.k)

    def step(self, i: int, x: dict) -> dict:
        """Search ``i`` with inputs ``x``: its wall time, from the call
        until ids, scores and stats are on the host, and its counters."""
        t0 = time.perf_counter()
        resp = self._search(x)
        t1 = time.perf_counter()
        st = resp.stats
        self.results[i] = (resp.ids, resp.scores, st["tiles_visited"],
                           st["postings_touched"])
        return {"latency_s": t1 - t0, "queries": len(x["terms"]),
                "steps": float(st["chunks_dispatched"].max()),
                "row_chunks": float(st["chunks_dispatched"].sum())}

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        self.retriever = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def sample(self, n_rows: int, searches: list) -> list:
        """``n_rows`` (search number, inputs, row) triples drawn from the
        seed among the window's searches."""
        rng = np.random.default_rng([self.seed, 3])
        b = self.traffic_gen.batch
        n = len(searches) * b
        pick = np.sort(rng.choice(n, min(n_rows, n), replace=False))
        inputs = {}
        out = []
        for p in pick:
            i, r = searches[int(p) // b], int(p) % b
            if i not in inputs:
                inputs[i] = self.traffic_gen.search(i)
            out.append((i, inputs[i], r))
        return out

    def merged(self, dtype=torch.float32) -> twogti.Merged:
        """The reference's merged postings, from the corpus made again
        from the seed; ``dtype`` rounds the weights (the control)."""
        c = gen.make_corpus(self.cfg, self.seed, self.device)
        return twogti.merge(c, dtype)

    def _k1(self, ref_m, rows, visited) -> dict:
        """``roofline.k1_counts`` of ``rows`` that visited ``visited``
        tiles each (the program's counter: the replay's on the sample)."""
        ts = self.cfg["index"]["tile_size"]
        sc = twogti.schedule(ref_m, rows, self.cfg["pruning"], ts)
        return k1_counts(twogti.visit_order_runs(ref_m, sc, ts), sc.real,
                         torch.as_tensor(visited, device=self.device))

    def k1_work(self, ref_m, searches: list) -> dict:
        """K1's work in the searches ``searches``, counted from the index
        made again from the seed and each row's schedule: sums of
        ``roofline.k1_counts`` over every row."""
        total = dict.fromkeys(("postings", "pad_postings", "tile_terms",
                               "tiles"), 0)
        for i in searches:
            x = self.traffic_gen.search(i)
            picked = [(i, x, r) for r in range(len(x["terms"]))]
            (_, rows), = _rows(picked, self.device)
            tv = self.results[i][2].astype(np.int64)
            for key, v in self._k1(ref_m, rows, tv).items():
                total[key] += int(v.sum())
        return total

    def check(self, n_rows: int, searches: list, ref_m=None,
              control=None, work: bool = False) -> dict:
        """The reference's numbers for a sample of the window's rows,
        against the program's answers, or, given ``control`` (merged
        postings in a lower precision), against the reference replayed on
        them in the program's place. With ``work``, also K1's work in all
        of ``searches`` (``k1_work``)."""
        t0 = time.perf_counter()
        ref_m = self.merged() if ref_m is None else ref_m
        p, ts = self.cfg["pruning"], self.cfg["index"]["tile_size"]
        valid, rank = [], []
        differ = {"tiles_visited": 0, "postings_touched": 0,
                  "k1_postings": 0}
        for pairs, rows in _rows(self.sample(n_rows, searches), self.device):
            ref = twogti.replay(ref_m, rows, p, self.k, ts)
            if control is not None:
                ctl = twogti.replay(control, rows, p, self.k, ts)
                ids, sc = ctl.ids, ctl.scores
            else:
                got = [self.results[i] for i, _, _ in pairs]
                rs = [r for _, _, r in pairs]
                ids, sc, tv, pt = (torch.from_numpy(np.stack(
                    [g[f][r] for g, r in zip(got, rs)])) for f in range(4))
                differ["tiles_visited"] += int((tv.to(ref.tiles_visited)
                                                != ref.tiles_visited).sum())
                differ["postings_touched"] += int(
                    (pt.to(ref.postings_touched)
                     != ref.postings_touched).sum())
                k1 = self._k1(ref_m, rows, tv.long())["postings"]
                differ["k1_postings"] += int((k1 != ref.live_postings).sum())
            v, r = twogti.compare(ref_m, rows, ref, ids, sc, p)
            valid.append(v)
            rank.append(r)
        valid, rank = torch.cat(valid), torch.cat(rank)
        out = {"numbers": twogti.numbers(valid, rank),
               "rows": int(valid.numel()),
               "rank_gap_top3": sorted(rank.tolist())[-3:],
               "check_s": time.perf_counter() - t0, "stats_differ": differ}
        if work:
            t1 = time.perf_counter()
            out["k1_work"] = self.k1_work(ref_m, searches)
            out["k1_work_s"] = time.perf_counter() - t1
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _allocated(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated()
        return 0
