"""DEPRECATED synchronous serving facade over the v2 scheduler.

``RetrievalServer`` predates
:class:`repro_torch.serve.scheduler.AsyncRetrievalScheduler`; it is kept
as a thin shim so existing call sites keep returning the exact same
ids/scores, but new code should submit ``SearchRequest`` objects to the
scheduler directly (futures, mixed-k micro-batching, query-length
routing, response cache). The shim pins the legacy behavior: one engine
for every request, no routing, no cache, and the historical
``Request``/``run_workload`` latency accounting. Like the scheduler it
serves from ``device`` (``"cuda"`` by default).
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings

import numpy as np

from ..core.index import BlockedImpactIndex
from ..core.twolevel import TwoLevelParams, resolve_k
from ..retrieval import SearchRequest
from .router import single_route
from .scheduler import (AsyncRetrievalScheduler, SchedulerConfig,
                        aggregate_latencies, truncate_terms)


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 32
    max_wait_ms: float = 2.0
    pad_terms: int = 16


@dataclasses.dataclass
class Request:
    terms: np.ndarray
    qw_b: np.ndarray
    qw_l: np.ndarray
    t_enqueue: float = 0.0
    t_done: float = 0.0
    ids: np.ndarray | None = None
    scores: np.ndarray | None = None

    @property
    def latency_ms(self) -> float:
        """Enqueue -> results in ms; NaN while the request is in flight
        (``t_done`` unset) instead of a garbage negative number."""
        if not self.t_done:
            return math.nan
        return (self.t_done - self.t_enqueue) * 1e3


class RetrievalServer:
    """Deprecated: a synchronous queue over one engine. Use
    ``AsyncRetrievalScheduler`` (see the module docstring)."""

    def __init__(self, index: BlockedImpactIndex, params: TwoLevelParams,
                 cfg: ServerConfig | None = None, *,
                 engine: str = "batched", k: int | None = None,
                 device="cuda", **engine_opts):
        warnings.warn(
            "RetrievalServer is deprecated: use repro_torch.serve."
            "AsyncRetrievalScheduler (submit(SearchRequest) -> "
            "SearchHandle) for mixed-k micro-batching, query-length "
            "routing and response caching.",
            DeprecationWarning, stacklevel=2)
        self.params = params
        # None -> fresh per-instance config (a shared default instance would
        # leak max_batch/pad_terms mutations across servers)
        self.cfg = cfg if cfg is not None else ServerConfig()
        self.scheduler = AsyncRetrievalScheduler(
            index, params, self._sched_cfg(),
            routing=single_route(engine, **engine_opts), device=device)
        # legacy attributes: the index on the serving device, and the one
        # retriever every batch goes through
        self.index = self.scheduler.index
        self.retriever = self.scheduler._retriever("all")
        self.k = resolve_k(params, k)
        self.pending: list[Request] = []
        self.completed: list[Request] = []

    def _sched_cfg(self) -> SchedulerConfig:
        """Scheduler view of the (mutable) legacy config. The pinned
        behaviors: no cache, and no batch padding — the shim serves the
        exact row count the old server did."""
        return SchedulerConfig(max_batch=self.cfg.max_batch,
                               max_wait_ms=self.cfg.max_wait_ms,
                               pad_terms=self.cfg.pad_terms,
                               pad_batch=False, cache_size=0)

    def submit(self, req: Request, now: float) -> None:
        req.t_enqueue = now
        self.pending.append(req)

    def _truncate(self, r: Request) -> np.ndarray:
        """Indices of the ``pad_terms`` terms to keep (see
        ``scheduler.truncate_terms``)."""
        return truncate_terms(r.terms, r.qw_b, r.qw_l, self.cfg.pad_terms,
                              self.params.gamma)

    def _flush(self) -> None:
        batch, self.pending = (self.pending[:self.cfg.max_batch],
                               self.pending[self.cfg.max_batch:])
        # legacy config objects are mutated in place by callers; re-sync
        self.scheduler.cfg = self._sched_cfg()
        handles = [
            self.scheduler.submit(
                SearchRequest(terms=r.terms, weights_b=r.qw_b,
                              weights_l=r.qw_l, k=self.k),
                now=r.t_enqueue)
            for r in batch]
        self.scheduler.flush()
        for r, h in zip(batch, handles):
            resp = h.result()
            r.ids, r.scores, r.t_done = resp.ids[0], resp.scores[0], h.t_done
        self.completed.extend(batch)

    def run_workload(self, requests: list[Request], qps: float,
                     seed: int = 0) -> dict:
        """Poisson arrivals at ``qps``; synchronous single-host execution."""
        if not requests:  # nothing to serve: no lat array to reduce
            return {"n": 0, "mrt_ms": float("nan"), "p50_ms": float("nan"),
                    "p99_ms": float("nan"), "qps_achieved": 0.0}
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / qps, len(requests)))
        t0 = time.perf_counter()
        i = 0
        while i < len(requests) or self.pending:
            now = time.perf_counter() - t0
            while i < len(requests) and arrivals[i] <= now:
                self.submit(requests[i], t0 + arrivals[i])
                i += 1
            oldest_wait = (time.perf_counter() - self.pending[0].t_enqueue
                           if self.pending else 0.0)
            if (len(self.pending) >= self.cfg.max_batch
                    or (self.pending
                        and oldest_wait * 1e3 >= self.cfg.max_wait_ms)
                    or (i >= len(requests) and self.pending)):
                self._flush()
            elif not self.pending and i < len(requests):
                time.sleep(max(0.0, arrivals[i] - now))
        return aggregate_latencies([r.latency_ms for r in self.completed],
                                   time.perf_counter() - t0)
