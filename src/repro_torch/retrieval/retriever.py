"""The ``Retriever`` facade: one search entry point over every engine.

    index = build_index(corpus.merged("scaled"), tile_size=512)   # on cuda
    # or: index = compress_index(corpus.merged("scaled"), tile_size=512)
    r = Retriever.open(index, twolevel.fast(), engine="kernel",
                       traversal="chunked_fused")
    resp = r.search(terms=q_terms, weights_b=qw_b, weights_l=qw_l, k=10)
    resp.ids, resp.scores, resp.stats, resp.latency_ms

The facade owns the query-time mechanics:

  - **engine selection**: string-keyed registry (``engines.py``); the
    pruning policy (TwoLevelParams), the index and its device are fixed at
    ``open`` time, depth and threshold overrides are per call;
  - **padding**: ragged per-query term lists are padded to one [B, Nq]
    shape with zero-weight no-op terms;
  - **k-bucketing**: per-request ``k`` executes at the smallest bucket
    >= k and is truncated back (``k_buckets=None`` = exact mode), so the
    results equal the reference's for the same request;
  - **tracing**: with a ``repro_torch.obs.Tracer`` (``tracer=``; the
    default ``NULL_TRACER`` records nothing) each search is an
    ``rt.search`` span (``rows``, padded ``width``, real ``terms``, ``k``
    executed, ``chunks`` run) around ``rt.pad`` and the engine's own spans
    (``core.traversal``; the ``"batched"`` and ``"kernel"`` engines).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.twolevel import TwoLevelParams, resolve_k
from ..obs.spans import NULL_TRACER
from .contract import (K_BUCKETS, SearchRequest, SearchResponse, bucket_k,
                       resolve_ks)
from .engines import get_engine


def _cast2d(a, np_dtype, torch_dtype):
    """``a`` unchanged when it already has the dtype (a tensor stays on its
    device), else a cast copy."""
    if isinstance(a, torch.Tensor):
        return a.to(torch_dtype)
    return a if a.dtype == np_dtype else a.astype(np_dtype)


def _pad_queries(terms, weights_b, weights_l):
    """Rectangularize a query batch. [B, Nq] arrays or tensors pass through
    (the same objects when their dtype already matches; tensors keep their
    device); ragged per-query sequences are padded with zero-weight terms
    (score no-ops)."""
    if all(isinstance(a, (np.ndarray, torch.Tensor)) and a.ndim == 2
           for a in (terms, weights_b, weights_l)):
        return (_cast2d(terms, np.int32, torch.int32),
                _cast2d(weights_b, np.float32, torch.float32),
                _cast2d(weights_l, np.float32, torch.float32))
    try:
        arr = np.asarray(terms)
    except ValueError:  # ragged: numpy refuses inhomogeneous shapes
        arr = None
    if arr is not None and arr.dtype != object and arr.ndim == 2:
        return (arr.astype(np.int32),
                np.asarray(weights_b, dtype=np.float32),
                np.asarray(weights_l, dtype=np.float32))
    if (arr is not None and arr.dtype != object and arr.ndim == 1
            and arr.size and np.ndim(terms[0]) == 0):
        raise ValueError("terms must be a [B, Nq] batch or a list of "
                         "per-query term arrays, got a single flat query")
    lens = [len(t) for t in terms]
    b, n = len(terms), max(lens, default=1)
    t_pad = np.zeros((b, max(n, 1)), np.int32)
    wb_pad = np.zeros((b, max(n, 1)), np.float32)
    wl_pad = np.zeros((b, max(n, 1)), np.float32)
    for i, (t, wb, wl) in enumerate(zip(terms, weights_b, weights_l)):
        t_pad[i, :len(t)] = np.asarray(t)
        wb_pad[i, :len(t)] = np.asarray(wb)
        wl_pad[i, :len(t)] = np.asarray(wl)
    return t_pad, wb_pad, wl_pad


class Retriever:
    """Facade over a registered engine."""

    def __init__(self, engine, params: TwoLevelParams,
                 k_buckets=K_BUCKETS, generation: int = 0, metrics=None,
                 tracer=NULL_TRACER):
        self.engine = engine
        self.params = params
        # sorted: bucket_k picks the first bucket >= k in iteration order
        self.k_buckets = tuple(sorted(k_buckets)) if k_buckets else None
        # index generation tag, stamped on every response
        self.generation = generation
        # optional obs.MetricsRegistry: each search records its wall
        # latency into a per-engine histogram (search_ms/<engine>)
        self.metrics = metrics
        self._hist_search = (
            None if metrics is None
            else metrics.histogram(f"search_ms/{self.engine_name}"))
        self.tracer = tracer

    @classmethod
    def open(cls, index, params: TwoLevelParams | None = None,
             engine: str = "batched", *, device="cuda", k_buckets=K_BUCKETS,
             generation: int = 0, metrics=None, tracer=NULL_TRACER,
             **engine_opts) -> "Retriever":
        """Build a retriever: ``index`` (a ``BlockedImpactIndex``, a
        ``repro_torch.index.CompressedImpactIndex``, a
        ``core.dense_guided.DenseGuidedIndex`` for ``"dense"``, or a
        ``retrieval.hybrid.HybridIndex``, which every engine accepts and
        the hybrid ``"cascade"`` / ``"rrf"`` engines need) + pruning
        ``params`` + an engine name from the registry. The index is served
        from ``device`` (moved there if it lives elsewhere; asking for CUDA
        without a GPU raises). ``engine_opts`` go to the engine constructor
        (``traversal=...``, ``chunk_tiles=...`` for ``"batched"`` /
        ``"kernel"``, ``warmup=False`` for ``"sequential"``; ``depth=``,
        ``first_stage=`` and the first stage's options for ``"cascade"`` /
        ``"rrf"``, also ``rrf_k=`` for ``"rrf"``); ``metrics`` an optional
        ``repro_torch.obs.MetricsRegistry`` that collects per-engine search
        latency histograms; ``tracer`` a ``repro_torch.obs.Tracer`` for the
        searches' spans, which the engine gets too (an engine that records
        none refuses it)."""
        params = params if params is not None else TwoLevelParams()
        if tracer is not NULL_TRACER:
            engine_opts["tracer"] = tracer
        eng = get_engine(engine)(index, params, device=device,
                                 **engine_opts)
        return cls(eng, params, k_buckets=k_buckets, generation=generation,
                   metrics=metrics, tracer=tracer)

    @property
    def engine_name(self) -> str:
        return self.engine.name

    def replicate(self) -> "Retriever":
        """A serving replica: a fresh engine instance with the same
        configuration sharing the open index tensors."""
        replicate = getattr(self.engine, "replicate", None)
        if replicate is None:
            raise TypeError(
                f"engine {self.engine_name!r} does not support replica "
                f"cloning (no .replicate)")
        return Retriever(replicate(self.params), self.params,
                         k_buckets=self.k_buckets,
                         generation=self.generation, metrics=self.metrics,
                         tracer=self.tracer)

    def search(self, request: SearchRequest | None = None, *,
               terms=None, weights_b=None, weights_l=None, dense=None,
               k=None,
               threshold_factor: float | None = None) -> SearchResponse:
        """Execute one request (a SearchRequest, or its fields as kwargs).

        ``k`` falls back to the request default (DEFAULT_K, honoring a
        legacy ``TwoLevelParams(k=...)`` stash). ids/scores come back
        truncated to the requested ``k`` even when the engine executed at
        a larger bucket.

        ``k`` may also be a per-query [B] sequence (mixed-k batch): the
        engine runs *once* at the bucket of the largest entry and each
        row is truncated back to its own depth; slots beyond a row's k
        hold the empty-queue sentinels (id -1, score -inf), and
        ``SearchResponse.ks`` records the per-row depths."""
        if request is None:
            request = SearchRequest(
                terms=terms, weights_b=weights_b, weights_l=weights_l,
                dense=dense, k=k, threshold_factor=threshold_factor)
        elif any(v is not None for v in (terms, weights_b, weights_l,
                                         dense, k, threshold_factor)):
            raise TypeError("pass either a SearchRequest or field kwargs, "
                            "not both")
        ks = resolve_ks(request.k, request.batch_size())
        if ks is None:
            k_req = resolve_k(self.params, request.k)
        else:
            k_req = int(ks.max())
        k_exec = bucket_k(k_req, self.k_buckets)
        params = self.params
        if request.threshold_factor is not None:
            params = params.replace(
                threshold_factor=float(request.threshold_factor))

        tr = self.tracer
        with tr.span("rt.search") as span:
            if request.terms is not None:
                with tr.span("rt.pad"):
                    q_terms, qw_b, qw_l = _pad_queries(
                        request.terms, request.weights_b, request.weights_l)
                if tr.enabled:
                    span.set(rows=len(q_terms), width=int(q_terms.shape[1]),
                             terms=sum(map(len, request.terms)))
            else:
                q_terms = qw_b = qw_l = None

            # The engines return numpy results, so the window ends with the
            # ids, scores and stats on the host: what a caller waits for.
            t0 = time.perf_counter()
            res = self.engine.search(q_terms, qw_b, qw_l, request.dense,
                                     k=k_exec, params=params)
            latency_ms = (time.perf_counter() - t0) * 1e3
            if tr.enabled:
                span.set(k=k_exec)
                chunks = res.stats.get("chunks_dispatched")
                if chunks is not None and len(chunks):
                    span.set(chunks=int(chunks.max()))
        if self._hist_search is not None:
            self._hist_search.record(latency_ms)
        ids = np.asarray(res.ids)[:, :k_req]
        scores = np.asarray(res.scores)[:, :k_req]
        if ks is None:
            ks = np.full(ids.shape[0], k_req, np.int32)
        elif (ks < k_req).any():
            # mixed-k batch: mask each row beyond its own requested depth
            # with the engines' empty-queue sentinels
            dead = np.arange(k_req)[None, :] >= ks[:, None]
            ids = np.where(dead, np.int32(-1), ids)
            scores = np.where(dead, np.float32(-np.inf), scores)
        return SearchResponse(
            ids=ids, scores=scores,
            engine=self.engine_name, k=k_req, k_exec=k_exec,
            stats=res.stats, latency_ms=latency_ms,
            latencies_ms=res.latencies_ms, ks=ks,
            generation=self.generation)
