"""Async serving scheduler: futures, mixed-k micro-batches, routing, cache.

The v2 serving seam. ``submit(SearchRequest) -> SearchHandle`` admits a
request into a priority queue and returns immediately; a handle is a
future (``.done()`` / ``.result(timeout)``) that resolves to a
:class:`repro_torch.retrieval.SearchResponse`. Requests are grouped into
micro-batches by **(k-bucket x query-length class)** — the two
per-request decisions the paper makes matter (Section 4's depth/quality
tradeoff; Table 8's length-dependent engine preference) — and each
group dispatches under the usual serving deadlines (``max_batch`` rows
or the oldest request's ``max_wait_ms``). One ``Retriever.search`` call
serves the whole batch with **per-request k**: the engine executes once
at the group's bucket and every row is truncated back to its own depth.

Static shapes: every dispatched batch is padded to a
``[max_batch, width]`` shape (``pad_batch=True``), where ``width`` is
the route's ``pad_terms`` (or the scheduler default) — so a
(k-bucket x length-class) group runs **one batch shape** whatever its
fill level (the JAX package's reason is its compile cache; here it keeps
the kernels' grids and the allocator's blocks the same from batch to
batch). Padding rows are zero-weight queries: they score as no-ops,
never extend the chunk loop past the real rows, and are sliced off
before results surface. A short route's narrow width is where length
routing pays on the batched engines: the planner/gather cost scales
with the padded query width.

Query-length routing (``serve.router``): a declarative
:class:`RoutingPolicy` maps live-term counts to engine configurations
(Table 8: short queries -> finer ``chunk_tiles``; long -> coarser
chunks or the fused kernel). One ``Retriever`` is opened per route,
lazily.

Device: the scheduler serves from one device (``device="cuda"`` by
default; asking for CUDA without a GPU raises, nothing falls back to the
CPU). It moves the index there **once** — at construction, and on
``swap_index`` for the new index — and opens every route's
``Retriever`` on that one copy; executor replicas share it. Requests
stay on the host: tensor fields (on any device) are read to numpy once
at submit, and responses come back as numpy.

Response cache: an LRU keyed on ``(query fingerprint, policy hash,
k-bucket, per-row depths)``. A hit completes the handle at submit time
— the zero-service-time path — and hit/miss counters surface in
``stats()``. Keying on the exact depths lets the same query coexist at
several k within one bucket, and means a hit is always the exact
request replayed (within a bucket, different depths are different
truncations of the same execution for rank-safe configs, but guided
configs are only reproducible at the exact request — the cache never
approximates). Entries and delivered responses never share arrays.

Fault tolerance (``serve.health`` / ``serve.faults``): requests may
carry a ``deadline_ms`` — expired entries are shed at pick time
(:class:`DeadlineExceeded`) instead of burning batch slots; failed
batch executions requeue under a per-route :class:`RetryPolicy`
(deterministic seeded backoff) when the fault is retryable; idle
executors hedge straggler batches (first result wins, the loser is
cancelled at the queue); per-executor circuit breakers take failing
executors out of rotation and, while the pool is degraded, routes with
a ``fallback`` lane execute there with responses flagged
``degraded=True``. ``swap_index`` installs a rebuilt index as a new
*generation* behind a two-phase gate (warm, then flip between
batches); cache keys carry the generation, so a rebuild can never
serve stale hits.

Observability (``repro_torch.obs``): the scheduler always owns a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (queue-wait and batch
service-time histograms feed the ``queue_wait_ms`` percentiles in
``stats()``), and — when ``SchedulerConfig.tracer`` carries a real
:class:`~repro_torch.obs.spans.Tracer` — records one trace per request
(admission -> queue -> execute spans, with the batch token, executor
id and the traversal's ``chunks_dispatched`` attached), emitted
retroactively at delivery so in-flight requests hold timestamps, not
span objects. With the default no-op tracer the whole path is a single
attribute check. ``sort_batches_by_cost`` orders each picked group by
a trace-fitted chunk-count prediction
(:class:`~repro_torch.obs.cost.CostModel`) within an aged-priority
level, so micro-batches cluster similar-cost requests and the chunk
loop's max-over-batch trip count hugs the mean; per-query
results are independent of batch composition, so cost-sorted dispatch
is bit-identical to unsorted (pinned by test).

Two drive modes:

  - synchronous: ``poll()`` dispatches every *due* micro-batch inline
    and ``flush()`` drains everything — deterministic, what the
    benchmarks, the deprecated ``RetrievalServer`` shim, and most tests
    use;
  - threaded: ``start()`` (or ``with scheduler:``) runs a background
    worker (or, with ``executors > 0``, an
    :class:`~repro_torch.serve.executor.ExecutorPool`, one CUDA stream
    per slot) that wakes on submissions and deadlines; ``result()`` then
    blocks like any future. ``close()`` stops the worker and drains.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..core.index import resolve_device
from ..core.twolevel import TwoLevelParams, resolve_k
from ..obs.cost import CostModel, QueryFeaturizer
# the one copy of the serving latency accounting; re-exported here, where
# the JAX package keeps it
from ..obs.metrics import MetricsRegistry, aggregate_latencies  # noqa: F401
from ..obs.spans import NULL_TRACER
from ..retrieval import (K_BUCKETS, Retriever, SearchRequest,
                         SearchResponse, bucket_k, resolve_ks)
from .health import HealthConfig, HealthMonitor, RetryPolicy
from .router import (RoutingPolicy, query_length, single_route,
                     warmup_grid)


ADMISSION_POLICIES = ("block", "reject", "shed")
CACHE_ADMISSIONS = ("always", "second_sight")


class SchedulerSaturated(RuntimeError):
    """The bounded admission queue is full. Raised by ``submit`` under
    ``admission_policy="reject"`` (and for a submission that loses the
    priority comparison under ``"shed"``); delivered through
    ``SearchHandle.result()`` for a queued request that was load-shed to
    admit a more important one."""


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_ms`` budget ran out while it was still
    queued: the scheduler sheds it at pick time instead of spending a
    batch slot on an answer nobody is waiting for. Delivered through
    ``SearchHandle.result()``; counted as ``expired`` in ``stats()``."""


class SearchTimeout(TimeoutError):
    """``SearchHandle.result(timeout=...)`` gave up waiting. Unlike
    :class:`DeadlineExceeded` the request itself is still live — only
    this caller stopped waiting. Carries the handle's routing context
    so timeout logs can say *which* lane stalled."""

    def __init__(self, msg: str, route: str | None = None,
                 k_bucket: int | None = None):
        super().__init__(msg)
        self.route = route
        self.k_bucket = k_bucket


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 32        # rows per micro-batch (and the padded shape)
    max_wait_ms: float = 2.0   # oldest-request dispatch deadline
    pad_terms: int = 16        # static query width (overlong rows truncate)
    # pad every batch to [max_batch, pad_terms] so a (k-bucket x class)
    # group runs one batch shape regardless of fill level
    pad_batch: bool = True
    cache_size: int = 256      # LRU response-cache entries; 0 disables
    # -- executor pool / backpressure (serve.executor) ----------------------
    # worker threads started by start(): 0 keeps the single dispatch
    # worker; N >= 1 runs an ExecutorPool of N workers, each with its own
    # Retriever replica per route and, on CUDA, its own stream, pulling
    # micro-batches concurrently
    executors: int = 0
    # bounded admission: max queued rows (pending, not yet picked);
    # 0 = unbounded. Saturation then degrades tail latency (or sheds)
    # instead of growing MRT without bound for everyone.
    admission_limit: int = 0
    # what submit() does when the queue is full:
    #   "block"  — wait for space (inline-drains in sync mode);
    #   "reject" — raise SchedulerSaturated immediately;
    #   "shed"   — drop the least-important queued request (by aged
    #              priority; its handle fails with SchedulerSaturated)
    #              if the new one outranks it, else refuse the new one.
    admission_policy: str = "block"
    # priority aging: a queued request gains one priority level per
    # aging_ms waited, so strict priority cannot starve low-priority
    # traffic under a saturating high-priority stream. 0 = strict.
    aging_ms: float = 0.0
    # -- fault tolerance (serve.health / serve.faults) -----------------------
    # scheduler-wide retry policy for failed batch executions (a Route
    # may override with its own); None = fail handles on first error
    retry: RetryPolicy | None = None
    # hedge straggler batches: an idle executor re-dispatches a batch
    # that has been in flight longer than hedge_ms on itself; first
    # result wins, the loser is cancelled at the queue (or discarded).
    # 0 disables unless hedge_from_p99 derives the delay from the
    # health monitor's recent-latency p99 (hedge_ms is then the
    # cold-start default before any latency samples exist).
    hedge_ms: float = 0.0
    hedge_from_p99: bool = False
    # per-executor breaker/EWMA configuration; None = defaults
    health: HealthConfig | None = None
    # -- cache lifecycle -----------------------------------------------------
    # entries older than ttl_s are evicted on lookup; 0 = no TTL
    cache_ttl_s: float = 0.0
    # "always" caches every response; "second_sight" only admits a key
    # seen before (one-hit wonders never displace a repeating query)
    cache_admission: str = "always"
    # -- observability (repro_torch.obs) -------------------------------------
    # tracer for per-request spans (admission -> queue -> execute);
    # None = the shared no-op tracer, whose entire cost on the serving
    # path is one attribute check per delivery
    tracer: object | None = None
    # metrics registry (queue-wait / service-time histograms, stats()
    # percentiles); None = a private registry per scheduler
    metrics: MetricsRegistry | None = None
    # trace-fitted chunk-count predictor (obs.cost.CostModel). With
    # sort_batches_by_cost, each picked group orders by predicted cost
    # *within* an aged-priority level, clustering similar-cost requests
    # per micro-batch so the chunk loop's max-over-batch trip count hugs
    # the mean. Per-query results are batch-composition
    # independent, so dispatch order never changes ids/scores.
    cost_model: CostModel | None = None
    sort_batches_by_cost: bool = False


def truncate_terms(terms, qw_b, qw_l, pad_terms: int,
                   gamma: float) -> np.ndarray:
    """Indices of the ``pad_terms`` terms to keep for one over-long
    query: drop the *lowest-impact* terms — ranked by the gamma-combined
    query weight the engine scores with — not the trailing ones, and
    preserve the original term order among the kept."""
    if len(terms) <= pad_terms:
        return np.arange(len(terms))
    impact = (gamma * np.asarray(qw_b, np.float32)
              + (1.0 - gamma) * np.asarray(qw_l, np.float32))
    keep = np.argsort(-impact, kind="stable")[:pad_terms]
    return np.sort(keep)


def _host(a):
    """A request field on the host: a tensor, on any device, becomes a
    numpy array (one copy); anything else passes through."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


class SearchHandle:
    """Future-style result of one :meth:`AsyncRetrievalScheduler.submit`.

    ``done()`` is non-blocking; ``result(timeout=None)`` blocks until
    the response exists (with a worker thread running this is a plain
    future wait; without one it flushes the scheduler so a bare
    submit->result round trip can never deadlock). ``cached`` marks the
    zero-service-time path; ``latency_ms`` is submit->completion and
    NaN while the request is still in flight.
    """

    __slots__ = ("route", "k_bucket", "priority", "cached", "t_submit",
                 "t_done", "deadline_ms", "_event", "_response",
                 "_exception", "_scheduler")

    def __init__(self, scheduler, route: str, k_bucket: int,
                 priority: int, t_submit: float,
                 deadline_ms: float | None = None):
        self.route = route
        self.k_bucket = k_bucket
        self.priority = priority
        self.cached = False
        self.t_submit = t_submit
        self.t_done = math.nan
        self.deadline_ms = deadline_ms
        self._event = threading.Event()
        self._response: SearchResponse | None = None
        self._exception: BaseException | None = None
        self._scheduler = scheduler

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> SearchResponse:
        if not self._event.is_set() and not self._scheduler.is_running():
            # drain to completion: an *unrelated* batch failing mid-flush
            # already resolved its own handles with the error, but ours
            # may still be queued behind it — keep flushing (each failed
            # batch is popped, so this terminates) instead of letting the
            # foreign exception escape or a timeout=None wait deadlock
            while not self._event.is_set():
                try:
                    self._scheduler.flush()
                    break
                except Exception:
                    continue
        if not self._event.wait(timeout):
            raise SearchTimeout(
                f"request not served within {timeout}s (route "
                f"{self.route!r}, k-bucket {self.k_bucket})",
                route=self.route, k_bucket=self.k_bucket)
        if self._exception is not None:
            raise self._exception
        return self._response

    @property
    def latency_ms(self) -> float:
        """Submit -> completion in ms; NaN while in flight."""
        if not self._event.is_set():
            return math.nan
        return (self.t_done - self.t_submit) * 1e3

    def _complete(self, response: SearchResponse, t_done: float,
                  cached: bool = False) -> None:
        self._response = response
        self.t_done = t_done
        self.cached = cached
        self._event.set()

    def _fail(self, exc: BaseException, t_done: float) -> None:
        """Deliver a batch-execution failure: ``result()`` re-raises.
        The request is gone either way, but the caller finds out instead
        of blocking forever on a handle nothing will ever complete."""
        self._exception = exc
        self.t_done = t_done
        self._event.set()


@dataclasses.dataclass
class _Pending:
    """One admitted request, normalized to static-width rows."""
    seq: int
    priority: int
    deadline: float            # absolute perf_counter dispatch deadline
    handle: SearchHandle
    terms: np.ndarray          # [r, pad_terms] int32
    qw_b: np.ndarray           # [r, pad_terms] f32
    qw_l: np.ndarray           # [r, pad_terms] f32
    ks: np.ndarray             # [r] int32 per-row depth
    cache_key: tuple | None    # generation-free base key; gen appended
    #                            at store/lookup time
    expires: float = math.inf  # absolute deadline_ms expiry; shed after
    not_before: float = -math.inf  # retry backoff: ineligible until then
    attempts: int = 1          # execution attempts including the next one
    cost: float = 0.0          # predicted chunk count (cost-sorted pick)
    features: tuple | None = None  # heaviest row's cost features (tracing)

    @property
    def rows(self) -> int:
        return self.terms.shape[0]


@dataclasses.dataclass
class _Inflight:
    """One picked batch between pick and delivery — the unit retries,
    hedges, and first-result-wins races are resolved on. ``outstanding``
    counts live attempts (primary + hedges); the first ``_deliver`` pops
    the record, so a losing attempt finds it gone and is discarded."""
    token: int
    key: tuple                 # (bucket, route_name, threshold_factor)
    batch: list                # the _Pending entries
    t_start: float
    budget_ms: float           # min remaining deadline budget over rows
    executor_id: int | None    # primary executor (hedges run elsewhere)
    attempts: int = 1
    outstanding: int = 1
    hedged: bool = False


class AsyncRetrievalScheduler:
    """The v2 serving loop: priority admission, (k-bucket x length-class)
    micro-batching, per-request k, query-length routing, response cache.

    One instance owns one index (moved to ``device`` once) + pruning
    policy and a lazily-opened ``Retriever`` per route. See the module
    docstring for semantics.
    """

    def __init__(self, index, params: TwoLevelParams | None = None,
                 cfg: SchedulerConfig | None = None, *,
                 routing: RoutingPolicy | None = None,
                 k_buckets=K_BUCKETS, faults=None, device="cuda"):
        self.device = resolve_device(device)
        # on CUDA: the stream each generation's index was moved to the card
        # on; a pool slot's stream waits on it before its first batch of
        # that generation (ExecutorPool)
        self._upload_streams: dict[int, torch.cuda.Stream] = {}
        self.index = self._upload(index, 0)
        self.params = params if params is not None else TwoLevelParams()
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.routing = routing if routing is not None else single_route()
        self.k_buckets = k_buckets
        if self.cfg.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy must be one of {ADMISSION_POLICIES}, "
                f"got {self.cfg.admission_policy!r}")
        if self.cfg.cache_admission not in CACHE_ADMISSIONS:
            raise ValueError(
                f"cache_admission must be one of {CACHE_ADMISSIONS}, "
                f"got {self.cfg.cache_admission!r}")
        if self.cfg.executors < 0:
            raise ValueError(f"executors must be >= 0, "
                             f"got {self.cfg.executors}")
        if self.cfg.sort_batches_by_cost and self.cfg.cost_model is None:
            raise ValueError("sort_batches_by_cost=True requires a "
                             "cost_model (fit one with "
                             "scripts/fit_cost_model.py or "
                             "obs.cost.CostModel.fit_from_traces)")
        self.tracer = (self.cfg.tracer if self.cfg.tracer is not None
                       else NULL_TRACER)
        self.metrics = (self.cfg.metrics if self.cfg.metrics is not None
                        else MetricsRegistry())
        self._hist_queue = self.metrics.histogram("queue_wait_ms")
        self._hist_service = self.metrics.histogram("batch_service_ms")
        # lazily-built query featurizer (needs only index stats arrays);
        # invalidated by swap_index so features track the live index
        self._featurizer: QueryFeaturizer | None = None
        self._policy_fp = self.routing.fingerprint(self.params)
        self._retrievers: dict[str, Retriever] = {}
        # (bucket, route_name, threshold_factor) -> list of _Pending
        # (ordered by aged priority at pick time, not at admission)
        self._groups: dict[tuple, list] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._open_lock = threading.Lock()   # lazy Retriever.open guard
        self._thread: threading.Thread | None = None
        self._pool = None                    # ExecutorPool when executors>0
        self._stop = False
        self._cache: OrderedDict = OrderedDict()
        # second-sight admission ghost list: base keys seen once (LRU)
        self._cache_seen: OrderedDict = OrderedDict()
        # fault tolerance: per-executor health/breakers, the no-op-able
        # fault hook, picked-batch records (retry/hedge bookkeeping),
        # and the index generation the hot-swap gate bumps
        self.health = HealthMonitor(self.cfg.health)
        self.faults = faults
        self._generation = 0
        self._inflight: dict[int, _Inflight] = {}
        self._inflight_seq = itertools.count()
        self._fault_global = 0
        self._fault_per_exec: dict = {}
        self._dead_executors: dict = {}
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "rejected": 0, "shed": 0, "expired": 0,
                        "in_flight": 0,
                        "batches": 0, "cache_hits": 0, "cache_misses": 0,
                        "rows_executed": 0, "rows_padding": 0,
                        "retries": 0, "hedges": 0, "hedges_wasted": 0,
                        "hedges_cancelled": 0, "hedge_failures": 0,
                        "degraded_batches": 0, "executor_deaths": 0,
                        "swaps": 0, "cache_ttl_evictions": 0,
                        "cache_admission_skips": 0,
                        "cache_gen_evictions": 0}
        self._route_requests: dict[str, int] = {}
        self._group_batches: dict[str, int] = {}
        self._executor_batches: dict[int, int] = {}
        self._executor_rows: dict[int, int] = {}
        self._warmup_s = 0.0

    # -- admission -----------------------------------------------------------

    def submit(self, request: SearchRequest | None = None, *,
               terms=None, weights_b=None, weights_l=None, k=None,
               threshold_factor: float | None = None,
               deadline_ms: float | None = None,
               priority: int = 0, now: float | None = None) -> SearchHandle:
        """Admit one request; returns its future immediately.

        ``priority`` orders dispatch within a micro-batch group (lower =
        sooner; FIFO within a priority). ``now`` overrides the admission
        timestamp (perf_counter scale) for simulated workloads. A
        response-cache hit completes the handle before returning.
        ``deadline_ms`` bounds queueing: a request still undispatched
        when its budget runs out is shed at pick time and its handle
        fails with :class:`DeadlineExceeded`.
        """
        if request is None:
            request = SearchRequest(terms=terms, weights_b=weights_b,
                                    weights_l=weights_l, k=k,
                                    threshold_factor=threshold_factor,
                                    deadline_ms=deadline_ms)
        elif any(v is not None for v in (terms, weights_b, weights_l, k,
                                         threshold_factor, deadline_ms)):
            raise TypeError("pass either a SearchRequest or field kwargs, "
                            "not both")
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {request.deadline_ms}")
        if request.dense is not None:
            raise ValueError("the scheduler serves sparse engines; use a "
                             "Retriever(engine='dense') directly for dense "
                             "requests")
        now = time.perf_counter() if now is None else now
        rows, qlen = self._normalize_rows(request)
        if not rows:
            raise ValueError("request carries a zero-row query batch")
        if len(rows) > self.cfg.max_batch:
            # an oversized atomic request would dispatch at its own row
            # count, a batch shape outside the serving grid — split it
            # client-side instead
            raise ValueError(
                f"request has {len(rows)} rows > max_batch="
                f"{self.cfg.max_batch}; split it into <= max_batch-row "
                f"requests (each request rides one micro-batch)")
        route = self.routing.classify(qlen)
        width = (route.pad_terms if route.pad_terms is not None
                 else self.cfg.pad_terms)
        q_terms, qw_b, qw_l = self._pad_rows(rows, width)
        ks = resolve_ks(request.k, q_terms.shape[0])
        if ks is None:
            ks = np.full(q_terms.shape[0],
                         resolve_k(self.params, request.k), np.int32)
        bucket = bucket_k(int(ks.max()), self.k_buckets)
        tf = (None if request.threshold_factor is None
              else float(request.threshold_factor))
        handle = SearchHandle(self, route.name, bucket, priority, now,
                              deadline_ms=request.deadline_ms)
        key = None
        if self.cfg.cache_size > 0:
            # per-row depths are part of the key, so the same query at
            # different k within one bucket keeps separate entries
            # instead of thrashing a single slot; the index generation
            # is appended at lookup/store time, so a hot-swap atomically
            # orphans every pre-swap entry
            key = (self._fingerprint(q_terms, qw_b, qw_l, tf),
                   self._policy_fp, bucket, ks.tobytes())
        n_rows = q_terms.shape[0]
        if 0 < self.cfg.admission_limit < n_rows:
            raise ValueError(
                f"request has {n_rows} rows > admission_limit="
                f"{self.cfg.admission_limit}; it could never be admitted")
        with self._cond:
            self._counts["submitted"] += 1
            self._route_requests[route.name] = (
                self._route_requests.get(route.name, 0) + 1)
            if key is not None:
                hit = self._cache_lookup_locked(key, now)
                if hit is not None:
                    self._counts["cache_hits"] += 1
                    self._counts["completed"] += 1
                    handle._complete(self._detach(hit, latency_ms=0.0),
                                     t_done=now, cached=True)
                    if self.tracer.enabled:
                        self.tracer.emit(
                            "request", now, now, trace_id=next(self._seq),
                            route=route.name, k_bucket=bucket,
                            priority=priority, rows=q_terms.shape[0],
                            cached=True, outcome="cached")
                    return handle
                self._counts["cache_misses"] += 1
        expires = (math.inf if request.deadline_ms is None
                   else now + request.deadline_ms / 1e3)
        cost_pred, feats = 0.0, None
        if self.cfg.sort_batches_by_cost or self.tracer.enabled:
            F = self._featurize(q_terms, qw_b, qw_l)
            # a multi-row request rides one batch slot; its heaviest row
            # (by upper-bound mass) is the one that paces the chunk loop
            heavy = F[int(np.argmax(F[:, 1]))]
            feats = tuple(float(x) for x in heavy)
            if self.cfg.cost_model is not None:
                cost_pred = float(self.cfg.cost_model.predict(F).max())
        entry = _Pending(
            seq=next(self._seq), priority=priority,
            deadline=min(now + self.cfg.max_wait_ms / 1e3, expires),
            handle=handle, terms=q_terms, qw_b=qw_b, qw_l=qw_l, ks=ks,
            cache_key=key, expires=expires, cost=cost_pred,
            features=feats)
        self._admit(entry, (bucket, route.name, tf), now)
        return handle

    def _featurize(self, terms, qw_b, qw_l) -> np.ndarray:
        f = self._featurizer
        if f is None:
            f = QueryFeaturizer(self.index, self.params)
            self._featurizer = f
        return f(terms, qw_b, qw_l)

    def _cache_lookup_locked(self, base_key: tuple, now: float):
        """Current-generation cache hit for ``base_key``, honoring TTL
        (an over-age entry is evicted and counts as a miss)."""
        full = base_key + (self._generation,)
        slot = self._cache.get(full)
        if slot is None:
            return None
        resp, stored_at = slot
        if 0 < self.cfg.cache_ttl_s < (now - stored_at):
            del self._cache[full]
            self._counts["cache_ttl_evictions"] += 1
            return None
        self._cache.move_to_end(full)
        return resp

    # -- backpressure --------------------------------------------------------

    def _aged_priority(self, priority: float, t_submit: float,
                       now: float) -> float:
        """Effective priority after aging: one level gained per
        ``aging_ms`` waited (lower = more important). With aging off this
        is the static priority — strict, starvation-prone ordering."""
        if self.cfg.aging_ms <= 0:
            return float(priority)
        return priority - (now - t_submit) * 1e3 / self.cfg.aging_ms

    def _pending_rows_locked(self) -> int:
        return sum(e.rows for g in self._groups.values() for e in g)

    def _admit(self, entry: _Pending, group_key: tuple, now: float) -> None:
        """Enqueue under the bounded admission queue. "block" waits for
        space (inline-draining when no worker runs, so a sync caller can
        never deadlock itself); "reject" raises ``SchedulerSaturated``;
        "shed" drops the least-important queued request — by *aged*
        priority, newest first within a class — when the incoming one
        outranks it, else refuses the incoming request."""
        limit = self.cfg.admission_limit
        while True:
            with self._cond:
                if limit <= 0 or (self._pending_rows_locked() + entry.rows
                                  <= limit):
                    self._groups.setdefault(group_key, []).append(entry)
                    self._cond.notify_all()
                    return
                if self.cfg.admission_policy == "reject":
                    self._counts["rejected"] += 1
                    raise SchedulerSaturated(
                        f"admission queue full ({limit} rows); request "
                        f"rejected (priority {entry.priority})")
                if self.cfg.admission_policy == "shed":
                    self._shed_for_locked(entry, group_key, now)
                    return
                # "block": wait for the queue to drain. Completion,
                # shed, expiry, and pick all notify the condition, so
                # this wakes the moment space exists — the timeout is
                # only a backstop against a lost wakeup, not a poll
                # interval that quantizes admission latency.
                if self.is_running():
                    self._cond.wait(timeout=1.0)
                    continue
            # sync mode, no worker to drain the queue: dispatch inline
            # (outside the lock) and retry admission
            self.poll(now=None, force=True)

    def _shed_for_locked(self, entry: _Pending, group_key: tuple,
                         now: float) -> None:
        """Make room for ``entry`` by dropping least-important queued
        requests, or refuse ``entry`` when it is itself the least
        important. Victim handles fail with ``SchedulerSaturated``."""
        limit = self.cfg.admission_limit
        incoming = self._aged_priority(entry.priority,
                                       entry.handle.t_submit, now)
        while self._pending_rows_locked() + entry.rows > limit:
            victim_key, victim = None, None
            worst = (incoming, -1)
            for gk, group in self._groups.items():
                for e in group:
                    aged = self._aged_priority(e.priority,
                                               e.handle.t_submit, now)
                    if (aged, e.seq) > worst:
                        worst = (aged, e.seq)
                        victim_key, victim = gk, e
            if victim is None:
                # the incoming request is the least important in sight
                self._counts["rejected"] += 1
                raise SchedulerSaturated(
                    f"admission queue full ({limit} rows) of equal-or-"
                    f"higher-priority requests; request shed at admission "
                    f"(priority {entry.priority})")
            self._groups[victim_key].remove(victim)
            if not self._groups[victim_key]:
                del self._groups[victim_key]
            self._counts["shed"] += 1
            victim.handle._fail(SchedulerSaturated(
                f"request load-shed (aged priority {worst[0]:.2f}) to "
                f"admit a higher-priority request"), t_done=now)
        self._groups.setdefault(group_key, []).append(entry)
        self._cond.notify_all()

    def _normalize_rows(self, request: SearchRequest):
        """Split a request into per-query (terms, qw_b, qw_l) rows — a
        single flat query becomes one row — and report its live-term
        count (max over rows), which picks the route *before* any
        padding or truncation happens. Tensor fields, on any device, are
        read to the host here, once."""
        terms, qw_b, qw_l = (_host(a) for a in (
            request.terms, request.weights_b, request.weights_l))
        if terms is None:
            raise ValueError("scheduler requests need sparse terms/weights")
        nd = getattr(terms, "ndim", None)
        flat = (nd == 1 if nd is not None
                # plain sequence: flat iff empty or scalar first element
                else len(terms) == 0 or np.ndim(terms[0]) == 0)
        if flat:
            # one query — including the 0-term edge, which pads to an
            # all-zero-weight no-op row (the historical server behavior)
            terms, qw_b, qw_l = [terms], [qw_b], [qw_l]
        rows = [(np.asarray(_host(terms[i])),
                 np.asarray(_host(qw_b[i]), np.float32),
                 np.asarray(_host(qw_l[i]), np.float32))
                for i in range(len(terms))]
        qlen = max((query_length(wb, wl) for _, wb, wl in rows), default=0)
        return rows, qlen

    def _pad_rows(self, rows, width: int):
        """Static [r, width] row block: over-long rows keep their
        highest-impact terms (``truncate_terms``), short rows pad with
        zero-weight no-ops. ``width`` is the route's ``pad_terms`` (or
        the scheduler default), so a short length class executes at a
        narrow batch shape."""
        r = len(rows)
        out_t = np.zeros((r, width), np.int32)
        out_b = np.zeros((r, width), np.float32)
        out_l = np.zeros((r, width), np.float32)
        for i, (t, wb, wl) in enumerate(rows):
            keep = truncate_terms(t, wb, wl, width, self.params.gamma)
            n = len(keep)
            out_t[i, :n] = t[keep]
            out_b[i, :n] = wb[keep]
            out_l[i, :n] = wl[keep]
        return out_t, out_b, out_l

    @staticmethod
    def _fingerprint(terms, qw_b, qw_l, tf) -> bytes:
        h = hashlib.sha1()
        for a in (terms, qw_b, qw_l):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr(tf).encode())
        return h.digest()

    def _retriever(self, route_name: str) -> Retriever:
        retr = self._retrievers.get(route_name)
        if retr is None:
            # double-checked under the route lock: a worker poll and a
            # main-thread flush racing here must not open (and for the
            # sharded engine, partition) the same route twice
            with self._open_lock:
                retr = self._retrievers.get(route_name)
                if retr is None:
                    retr = self._open(self.routing.by_name(route_name),
                                      self.index, self.params,
                                      self._generation)
                    self._retrievers[route_name] = retr
        return retr

    def _open(self, route, index, params, generation: int) -> Retriever:
        """One route's Retriever on ``index``, which already lives on the
        scheduler's device (so the engine shares it, copying nothing).
        Its searches record into the scheduler's registry
        (``search_ms/<engine>``)."""
        return Retriever.open(index, params, engine=route.engine,
                              device=self.device, k_buckets=self.k_buckets,
                              generation=generation, metrics=self.metrics,
                              **route.opts())

    def _upload(self, index, generation: int):
        """``index`` on the scheduler's device (the same object when it is
        there already), noting the stream that moved it."""
        index = index.to(self.device)
        if self.device.type == "cuda":
            self._upload_streams[generation] = torch.cuda.current_stream(
                self.device)
        return index

    def _resolve_retriever(self, route_name: str,
                           retrievers: dict | None) -> tuple:
        """(retriever, generation) for one attempt. With a replica map
        (executor pool), a map left behind by a hot-swap is cleared and
        rebuilt from the new masters before use — the generation check
        is what makes the flip safe without stopping the pool. A map with
        a CUDA stream (the slot's, current in its worker) makes it wait,
        once per generation, on the stream that moved that generation's
        index to the card."""
        if retrievers is None:
            retr = self._retriever(route_name)
            return retr, retr.generation
        with self._lock:
            gen = self._generation
        if getattr(retrievers, "generation", gen) != gen:
            retrievers.clear()
            retrievers.generation = gen
        retr = retrievers.get(route_name)
        if retr is None:
            retr = self._retriever(route_name).replicate()
            retrievers[route_name] = retr
        stream = getattr(retrievers, "stream", None)
        gen = retr.generation
        if stream is not None and retrievers.ready_generation != gen:
            stream.wait_stream(self._upload_streams[gen])
            retrievers.ready_generation = gen
        return retr, gen

    # -- dispatch ------------------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._groups.values())

    def next_deadline(self) -> float | None:
        """Earliest actionable time among pending requests (absolute
        perf_counter time), or None when the queue is idle. An entry in
        retry backoff is not actionable before ``not_before``, so the
        sync driver never busy-spins on a backing-off queue."""
        with self._lock:
            deadlines = [max(e.deadline, e.not_before)
                         for g in self._groups.values() for e in g]
        return min(deadlines) if deadlines else None

    def poll(self, now: float | None = None, force: bool = False) -> int:
        """Dispatch every *due* micro-batch inline; returns the number of
        requests completed. A group is due when it can fill ``max_batch``
        rows or its oldest deadline has passed (``force`` dispatches
        everything — that is ``flush``)."""
        completed = 0
        while True:
            picked = self._pick_batch(
                time.perf_counter() if now is None else now, force)
            if picked is None:
                return completed
            completed += self._execute(*picked)

    def flush(self) -> int:
        """Drain: dispatch every pending request regardless of deadlines."""
        return self.poll(force=True)

    def _expire_locked(self, now: float) -> int:
        """Shed every queued entry whose deadline budget ran out: the
        handle fails with :class:`DeadlineExceeded` and the entry never
        occupies a batch slot. Called under the lock at pick time."""
        expired = []
        for gk in list(self._groups):
            keep = [e for e in self._groups[gk] if e.expires > now]
            if len(keep) != len(self._groups[gk]):
                expired.extend(e for e in self._groups[gk]
                               if e.expires <= now)
                if keep:
                    self._groups[gk] = keep
                else:
                    del self._groups[gk]
        if expired:
            self._counts["expired"] += len(expired)
            for e in expired:
                h = e.handle
                h._fail(DeadlineExceeded(
                    f"deadline of {h.deadline_ms}ms expired before "
                    f"dispatch (route {h.route!r}, k-bucket "
                    f"{h.k_bucket})"), t_done=now)
                if self.tracer.enabled:
                    self.tracer.emit(
                        "request", h.t_submit, now, trace_id=e.seq,
                        route=h.route, k_bucket=h.k_bucket,
                        priority=e.priority, rows=e.rows,
                        outcome="expired",
                        deadline_ms=h.deadline_ms)
            # expired rows free admission-queue space
            self._cond.notify_all()
        return len(expired)

    def _pick_batch(self, now: float, force: bool):
        """Pop one due micro-batch (whole requests, up to ``max_batch``
        rows) under the lock; execution happens outside it. Entries in
        retry backoff (``not_before`` in the future) are invisible
        unless ``force`` drains them early; already-expired entries are
        shed first and never picked."""
        with self._lock:
            self._expire_locked(now)
            due_key = None
            due_deadline = math.inf
            for key, group in self._groups.items():
                eligible = (group if force
                            else [e for e in group if e.not_before <= now])
                if not eligible:
                    continue
                rows = sum(e.rows for e in eligible)
                oldest = min(e.deadline for e in eligible)
                if force or rows >= self.cfg.max_batch or oldest <= now:
                    if oldest < due_deadline:
                        due_key, due_deadline = key, oldest
            if due_key is None:
                return None
            group = self._groups[due_key]
            # aged priority decides dispatch order *at pick time* (a
            # static heap order could not model aging); FIFO within a
            # level via seq. With sort_batches_by_cost, predicted chunk
            # count breaks ties within a priority level, so consecutive
            # micro-batches carry similar-cost rows and the chunk loop's
            # max-over-batch trip count stays near the batch mean.
            if self.cfg.sort_batches_by_cost:
                group.sort(key=lambda e: (
                    self._aged_priority(e.priority, e.handle.t_submit,
                                        now),
                    e.cost, e.seq))
            else:
                group.sort(key=lambda e: (
                    self._aged_priority(e.priority, e.handle.t_submit,
                                        now),
                    e.seq))
            batch, rows = [], 0
            i = 0
            while i < len(group):
                e = group[i]
                if not force and e.not_before > now:
                    i += 1
                    continue
                if batch and rows + e.rows > self.cfg.max_batch:
                    break
                group.pop(i)
                batch.append(e)
                rows += e.rows
            if not group:
                del self._groups[due_key]
            self._counts["in_flight"] += len(batch)
            # picked rows free admission-queue space: wake blocked submitters
            self._cond.notify_all()
            return due_key, batch

    def _execute(self, key: tuple, batch: list, *,
                 retrievers: dict | None = None,
                 executor_id: int | None = None,
                 now: float | None = None) -> int:
        """Run one picked batch. ``retrievers`` lets an executor slot
        substitute its own replica map for the shared one; the pool tags
        ``executor_id`` so per-executor batch/row counters (and the
        health monitor) aggregate per slot. ``now`` pins the clock for
        simulated-time tests (begin and completion share it)."""
        token = self._begin_batch(key, batch, executor_id, now)
        return self._run_attempt(token, retrievers=retrievers,
                                 executor_id=executor_id, now=now)

    def _begin_batch(self, key: tuple, batch: list,
                     executor_id: int | None,
                     now: float | None = None) -> int:
        """Register a picked batch as in flight: the token is what
        retries, hedges, and first-result-wins delivery key on. The
        record carries the min remaining deadline budget over its rows
        (inf with no deadlines) — what an executor could use to skip
        doomed work or size hedging."""
        now = time.perf_counter() if now is None else now
        budget = min((e.expires - now) * 1e3 for e in batch)
        with self._lock:
            token = next(self._inflight_seq)
            self._inflight[token] = _Inflight(
                token=token, key=key, batch=batch, t_start=now,
                budget_ms=budget, executor_id=executor_id,
                attempts=max(e.attempts for e in batch))
        return token

    def _run_attempt(self, token: int, *, retrievers: dict | None = None,
                     executor_id: int | None = None,
                     now: float | None = None) -> int:
        """One execution attempt of an in-flight batch (the primary
        pick, a retry, or a hedge). An attempt whose token is already
        gone was cancelled at the queue — the race winner delivered
        before this attempt started executing."""
        t_start = time.perf_counter() if now is None else now
        with self._lock:
            rec = self._inflight.get(token)
            if rec is None:
                self._counts["hedges_cancelled"] += 1
                return 0
            key, batch = rec.key, rec.batch
        bucket, route_name, tf = key
        # degraded mode: while any breaker is not closed, a route with a
        # fallback lane executes there (same padded width by policy
        # validation) and the responses are flagged degraded
        exec_route, degraded = route_name, False
        if self.health.degraded():
            fb = self.routing.by_name(route_name).fallback
            if fb is not None:
                exec_route, degraded = fb, True
        delay_ms = 0.0
        try:
            retr, gen = self._resolve_retriever(exec_route, retrievers)
            if self.faults is not None:
                b_idx, g_idx = self._next_indices(executor_id)
                delay_ms = self.faults.on_batch(
                    executor_id=executor_id, batch_index=b_idx,
                    global_index=g_idx, route=exec_route, generation=gen)
            resp, n_real, n_pad = self._search_batch(retr, batch, tf)
        except Exception as exc:
            return self._attempt_failed(token, exc, executor_id, now)
        t_done = time.perf_counter() if now is None else now
        n = self._deliver(token, resp, n_real, n_pad, degraded=degraded,
                          executor_id=executor_id, t_done=t_done)
        if executor_id is not None and n:
            # virtual fault delays count toward the EWMA/percentiles so
            # simulated-clock tests exercise real health dynamics
            self.health.record_success(
                executor_id, (t_done - t_start) * 1e3 + delay_ms, t_done)
        return n

    def _search_batch(self, retr: Retriever, batch: list, tf):
        """Concatenate + pad one batch to the static shape and run it."""
        terms = np.concatenate([e.terms for e in batch])
        qw_b = np.concatenate([e.qw_b for e in batch])
        qw_l = np.concatenate([e.qw_l for e in batch])
        ks = np.concatenate([e.ks for e in batch])
        n_real = terms.shape[0]
        n_pad = 0
        if self.cfg.pad_batch and n_real < self.cfg.max_batch:
            # zero-weight no-op rows: static [max_batch, pad_terms] shape
            # -> one shape per (k-bucket x length-class), any fill level
            n_pad = self.cfg.max_batch - n_real
            terms = np.concatenate(
                [terms, np.zeros((n_pad, terms.shape[1]), np.int32)])
            qw_b = np.concatenate(
                [qw_b, np.zeros((n_pad, qw_b.shape[1]), np.float32)])
            qw_l = np.concatenate(
                [qw_l, np.zeros((n_pad, qw_l.shape[1]), np.float32)])
            ks = np.concatenate([ks, np.ones(n_pad, np.int32)])
        resp = retr.search(terms=terms, weights_b=qw_b, weights_l=qw_l,
                           k=ks, threshold_factor=tf)
        return resp, n_real, n_pad

    def _deliver(self, token: int, resp: SearchResponse, n_real: int,
                 n_pad: int, *, degraded: bool,
                 executor_id: int | None, t_done: float) -> int:
        """First result wins: pop the in-flight record and complete the
        handles. A losing (hedged) attempt finds the record gone and its
        result is discarded. Completion notifies the condition — blocked
        submitters and deadline waiters wake immediately."""
        row0 = 0
        with self._cond:
            rec = self._inflight.pop(token, None)
            if rec is None:
                self._counts["hedges_wasted"] += 1
                return 0
            batch = rec.batch
            bucket, route_name, tf = rec.key
            self._counts["batches"] += 1
            self._counts["rows_executed"] += n_real
            self._counts["rows_padding"] += n_pad
            self._counts["in_flight"] -= len(batch)
            if degraded:
                self._counts["degraded_batches"] += 1
            gname = f"k{bucket}/{route_name}"
            self._group_batches[gname] = self._group_batches.get(gname, 0) + 1
            if executor_id is not None:
                self._executor_batches[executor_id] = (
                    self._executor_batches.get(executor_id, 0) + 1)
                self._executor_rows[executor_id] = (
                    self._executor_rows.get(executor_id, 0) + n_real)
            service_ms = max((t_done - rec.t_start) * 1e3, 0.0)
            self._hist_service.record(service_ms)
            tracing = self.tracer.enabled
            if tracing:
                self.tracer.emit(
                    "batch", rec.t_start, t_done,
                    trace_id=f"batch-{rec.token}", batch=rec.token,
                    route=route_name, k_bucket=bucket, rows=n_real,
                    padding=n_pad, attempts=rec.attempts,
                    degraded=degraded,
                    executor=-1 if executor_id is None else executor_id)
            for e in batch:
                rows = slice(row0, row0 + e.rows)
                row0 += e.rows
                k_e = int(e.ks.max())
                # materialized copies, not views: a view would pin the
                # whole padded batch alive for the cache's lifetime, and
                # a consumer mutating its response would corrupt the
                # shared cache entry
                sliced = SearchResponse(
                    ids=resp.ids[rows, :k_e].copy(),
                    scores=resp.scores[rows, :k_e].copy(),
                    engine=resp.engine, k=k_e, k_exec=resp.k_exec,
                    stats=self._slice_stats(resp.stats, rows,
                                            n_real + n_pad),
                    latency_ms=resp.latency_ms, ks=e.ks,
                    generation=resp.generation, degraded=degraded)
                # never cache a degraded (fallback-lane) response, nor
                # one a concurrent hot-swap already obsoleted — a stale
                # or approximate entry must not outlive the fault
                if (e.cache_key is not None and not degraded
                        and resp.generation == self._generation
                        and self._cache_admit_locked(e.cache_key)):
                    full = e.cache_key + (resp.generation,)
                    self._cache[full] = (self._detach(sliced), t_done)
                    self._cache.move_to_end(full)
                    while len(self._cache) > self.cfg.cache_size:
                        self._cache.popitem(last=False)
                self._counts["completed"] += 1
                e.handle._complete(sliced, t_done=t_done)
                self._hist_queue.record(
                    max((rec.t_start - e.handle.t_submit) * 1e3, 0.0))
                if tracing:
                    self._trace_request(rec, e, sliced, t_done,
                                        degraded, executor_id)
            self._cond.notify_all()
        return len(batch)

    def _trace_request(self, rec: _Inflight, e: _Pending,
                       sliced: SearchResponse, t_done: float,
                       degraded: bool, executor_id: int | None) -> None:
        """Emit one request's trace at delivery: a root ``request`` span
        with ``queue`` and ``execute`` children. Spans are emitted
        retroactively from the timestamps the scheduler already carries
        (handle.t_submit, the in-flight record's t_start, t_done), so
        tracing never adds state to the hot path. The execute span gets
        the traversal's per-query counters (``chunks_dispatched`` et
        al.) plus the cost-model features/prediction when present."""
        from ..obs import trace_exec
        t_sub = e.handle.t_submit
        root = self.tracer.emit(
            "request", t_sub, t_done, trace_id=e.seq,
            route=e.handle.route, k_bucket=e.handle.k_bucket,
            priority=e.priority, rows=e.rows, attempts=rec.attempts,
            degraded=degraded, outcome="completed")
        self.tracer.emit(
            "queue", t_sub, rec.t_start, trace_id=e.seq, parent=root,
            queue_wait_ms=float(max((rec.t_start - t_sub) * 1e3, 0.0)))
        attrs = trace_exec.request_attributes(sliced.stats)
        if e.features is not None:
            attrs["cost_features"] = list(e.features)
            if e.cost:
                attrs["cost_pred"] = e.cost
        self.tracer.emit(
            "execute", rec.t_start, t_done, trace_id=e.seq, parent=root,
            batch=rec.token, budget_ms=rec.budget_ms,
            executor=-1 if executor_id is None else executor_id,
            **attrs)

    def _cache_admit_locked(self, base_key: tuple) -> bool:
        """Admission filter: "always" stores every response;
        "second_sight" only stores keys seen before (the first sighting
        goes on an LRU ghost list), keeping one-hit wonders from
        displacing repeating queries."""
        if self.cfg.cache_admission == "always":
            return True
        seen = base_key in self._cache_seen
        self._cache_seen[base_key] = True
        self._cache_seen.move_to_end(base_key)
        while len(self._cache_seen) > max(8 * self.cfg.cache_size, 1024):
            self._cache_seen.popitem(last=False)
        if not seen:
            self._counts["cache_admission_skips"] += 1
        return seen

    def _attempt_failed(self, token: int, exc: BaseException,
                        executor_id: int | None,
                        now: float | None = None) -> int:
        """Resolve one failed attempt: absorb it while other attempts
        of the batch are still racing, requeue the rows with backoff
        when the route's retry policy covers the fault, else fail every
        handle and re-raise (sync callers see the error; workers survive
        it)."""
        t_done = time.perf_counter() if now is None else now
        if executor_id is not None:
            self.health.record_failure(executor_id, t_done)
        with self._cond:
            rec = self._inflight.get(token)
            if rec is None:
                # the race winner already delivered; this loss is moot
                self._counts["hedge_failures"] += 1
                return 0
            rec.outstanding -= 1
            if rec.outstanding > 0:
                # a hedge of this batch is still running — let it win
                self._counts["hedge_failures"] += 1
                return 0
            del self._inflight[token]
            batch = rec.batch
            bucket, route_name, tf = rec.key
            policy = self.routing.by_name(route_name).retry
            if policy is None:
                policy = self.cfg.retry
            if (policy is not None and policy.retryable(exc)
                    and rec.attempts < policy.max_attempts):
                # requeue with deterministic seeded backoff; the entries
                # become pick-eligible again at not_before
                delay = policy.delay_ms(
                    rec.attempts, token=min(e.seq for e in batch))
                for e in batch:
                    e.attempts = rec.attempts + 1
                    e.not_before = t_done + delay / 1e3
                self._groups.setdefault(rec.key, []).extend(batch)
                self._counts["retries"] += 1
                self._counts["in_flight"] -= len(batch)
                self._cond.notify_all()
                return 0
            self._counts["failed"] += len(batch)
            self._counts["in_flight"] -= len(batch)
            for e in batch:
                e.handle._fail(exc, t_done)
            self._cond.notify_all()
        raise exc

    # -- hedging -------------------------------------------------------------

    def hedge_due(self, now: float | None = None,
                  exclude_executor: int | None = None) -> list:
        """Mark straggler batches for hedged re-execution and return
        their tokens. A batch qualifies once it has been in flight
        longer than the hedge delay (``cfg.hedge_ms``, or the health
        monitor's recent p99 under ``hedge_from_p99``) and has no hedge
        yet. The caller runs ``_run_attempt(token, ...)`` for each
        token on a *different* executor (``exclude_executor`` filters
        out batches whose primary is the would-be hedger)."""
        delay = self.cfg.hedge_ms
        if self.cfg.hedge_from_p99:
            delay = self.health.latency_p99_ms(default=self.cfg.hedge_ms)
        if delay <= 0:
            return []
        now = time.perf_counter() if now is None else now
        tokens = []
        with self._lock:
            for token, rec in self._inflight.items():
                if rec.hedged:
                    continue
                if (exclude_executor is not None
                        and rec.executor_id == exclude_executor):
                    continue
                if (now - rec.t_start) * 1e3 < delay:
                    continue
                rec.hedged = True
                rec.outstanding += 1
                self._counts["hedges"] += 1
                tokens.append(token)
        return tokens

    # -- hot swap ------------------------------------------------------------

    def swap_index(self, index, params: TwoLevelParams | None = None, *,
                   warm: bool = True) -> int:
        """Install a rebuilt index as a new generation behind a
        two-phase gate. Phase 1 (no lock held, pool keeps serving): move
        the index to the scheduler's device (once), open fresh retrievers
        for every route on it at the next generation and warm them over
        the routing grid, so the flip never pays a first call's set-up.
        Phase 2 (under the scheduler lock, between batches):
        swap the masters, bump the generation, and purge every cache
        entry of an older generation. Batches already in flight finish
        on their old replica — their responses carry the old generation
        stamp and are never cached. Executor replica maps rebuild
        lazily on their next resolve. Returns the new generation."""
        with self._open_lock:
            params = self.params if params is None else params
            next_gen = self._generation + 1
            index = self._upload(index, next_gen)
            fresh = {route.name: self._open(route, index, params, next_gen)
                     for route in self.routing.all_routes}
            if warm:
                buckets = (self.k_buckets if self.k_buckets
                           else (resolve_k(params, None),))
                for route, width, bucket in warmup_grid(
                        self.routing, buckets, self.cfg.pad_terms):
                    b = self.cfg.max_batch
                    zero_w = np.zeros((b, width), np.float32)
                    fresh[route.name].search(
                        terms=np.zeros((b, width), np.int32),
                        weights_b=zero_w, weights_l=zero_w,
                        k=np.full(b, bucket, np.int32))
            with self._cond:
                self.index = index
                self.params = params
                self._policy_fp = self.routing.fingerprint(params)
                self._retrievers = fresh
                self._generation = next_gen
                # cost features are index-derived; refit lazily on the
                # new generation's stats arrays
                self._featurizer = None
                stale = [k for k in self._cache if k[-1] != next_gen]
                for k in stale:
                    del self._cache[k]
                self._counts["cache_gen_evictions"] += len(stale)
                self._counts["swaps"] += 1
                self._cond.notify_all()
        return next_gen

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    # -- executor liveness ---------------------------------------------------

    def _record_executor_death(self, executor_id: int | None,
                               exc: BaseException) -> None:
        """A worker thread died outside batch execution (batch failures
        resolve their own handles; this path has no handle to fail).
        The scheduler survives: the death is counted and surfaced in
        ``stats()``, the executor's breaker goes terminally dead, and
        waiters are notified so nothing blocks on the lost thread."""
        with self._cond:
            self._counts["executor_deaths"] += 1
            self._dead_executors[-1 if executor_id is None
                                 else executor_id] = repr(exc)
            self._cond.notify_all()
        if executor_id is not None:
            self.health.mark_dead(executor_id)

    def _next_indices(self, executor_id) -> tuple:
        """(per-executor, global) batch-attempt ordinals for the fault
        plan's positional matching."""
        with self._lock:
            g = self._fault_global
            self._fault_global += 1
            b = self._fault_per_exec.get(executor_id, 0)
            self._fault_per_exec[executor_id] = b + 1
        return b, g

    @staticmethod
    def _detach(resp: SearchResponse, **overrides) -> SearchResponse:
        """A response whose arrays (ids, scores, ks, per-query stats)
        are private copies. The cache entry and every delivered response
        must never alias: a consumer mutating its response would
        otherwise rewrite what later hits are served."""
        return dataclasses.replace(
            resp, ids=resp.ids.copy(), scores=resp.scores.copy(),
            ks=resp.ks.copy(),
            stats={n: v.copy() if isinstance(v, np.ndarray) else v
                   for n, v in resp.stats.items()},
            **overrides)

    @staticmethod
    def _slice_stats(stats: dict, rows: slice, batch_rows: int) -> dict:
        """Per-query counter arrays slice to the request's rows; scalar
        counters pass through unchanged."""
        out = {}
        for name, v in stats.items():
            arr = np.asarray(v)
            out[name] = (arr[rows].copy()
                         if arr.ndim >= 1 and arr.shape[0] == batch_rows
                         else v)
        return out

    # -- warmup --------------------------------------------------------------

    def warmup(self, buckets=None) -> float:
        """Warm the full serving grid — one zero-weight no-op batch per
        ``warmup_grid`` cell (route x k-bucket), at the route's static
        ``[max_batch, width]`` shape — so the first real request of
        *any* group never pays a first call's set-up (the kernel build,
        the allocator's first blocks). Kernel libraries and the
        allocator are process-wide, so one pass warms every executor
        replica at once. Returns the wall-seconds spent (cumulative;
        also surfaced as ``warmup_s`` in ``stats()``)."""
        t0 = time.perf_counter()
        if buckets is None:
            buckets = (self.k_buckets if self.k_buckets
                       else (resolve_k(self.params, None),))
        for route, width, bucket in warmup_grid(
                self.routing, buckets, self.cfg.pad_terms):
            retr = self._retriever(route.name)
            b = self.cfg.max_batch
            zero_w = np.zeros((b, width), np.float32)
            retr.search(terms=np.zeros((b, width), np.int32),
                        weights_b=zero_w, weights_l=zero_w,
                        k=np.full(b, bucket, np.int32))
        self._warmup_s += time.perf_counter() - t0
        return self._warmup_s

    # -- stats / cache -------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters: submissions, batches, cache hits/misses,
        per-route request counts, per-(bucket x class) and per-executor
        batch counts. The whole snapshot is read under the scheduler
        lock and returned as a detached dict (nested dicts copied), so
        a reader racing N executor threads sees one consistent moment:
        ``submitted == completed + failed + shed + rejected + expired +
        pending + in_flight`` holds in every snapshot."""
        with self._lock:
            counts = dict(self._counts)
            snap = {**counts,
                    "admitted": counts["submitted"] - counts["rejected"],
                    "warmup_s": self._warmup_s,
                    "cache_entries": len(self._cache),
                    "pending": sum(len(g) for g in self._groups.values()),
                    "pending_rows": self._pending_rows_locked(),
                    "generation": self._generation,
                    "dead_executors": dict(self._dead_executors),
                    "requests_by_route": dict(self._route_requests),
                    "batches_by_group": dict(self._group_batches),
                    "batches_by_executor": dict(self._executor_batches),
                    "rows_by_executor": dict(self._executor_rows)}
        # the health monitor has its own (leaf) lock; read outside ours
        snap["breakers"] = self.health.snapshot()
        # histograms carry their own (leaf) locks too: pick-to-submit
        # queue wait and batch service time as exact-rank-at-bucket
        # summaries ({"n": 0} before any delivery — never NaN)
        snap["queue_wait_ms"] = self._hist_queue.summary()
        snap["service_ms"] = self._hist_service.summary()
        return snap

    def cache_clear(self) -> None:
        with self._lock:
            self._cache.clear()

    # -- threaded mode -------------------------------------------------------

    def is_running(self) -> bool:
        if self._pool is not None and self._pool.is_running():
            return True
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AsyncRetrievalScheduler":
        """Run the background dispatch machinery (idempotent): the
        single worker thread, or — with ``cfg.executors > 0`` — an
        :class:`~repro_torch.serve.executor.ExecutorPool` of N workers,
        each holding its own Retriever replica per route (and, on CUDA,
        its own stream), warmed over the routing grid before any of them
        serves a request."""
        if self.is_running():
            return self
        self._stop = False
        if self.cfg.executors > 0:
            from .executor import ExecutorPool  # avoid an import cycle
            self._pool = ExecutorPool(self, self.cfg.executors)
            self._pool.start()
            return self
        self._thread = threading.Thread(
            target=self._worker, name="retrieval-scheduler", daemon=True)
        self._thread.start()
        return self

    def close(self, flush: bool = True) -> None:
        """Stop the worker(s); by default drain whatever is still
        queued — with a pool, the executors themselves drain the group
        queues before exiting, so close-time work still runs on every
        replica concurrently."""
        if self._pool is not None:
            self._pool.close(drain=flush)
            self._pool = None
        if self._thread is not None:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._thread.join()
            self._thread = None
        if flush:
            self.flush()

    def __enter__(self) -> "AsyncRetrievalScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _worker(self) -> None:
        try:
            self._worker_loop()
        except BaseException as exc:  # noqa: BLE001 — liveness accounting
            # death outside batch execution (batch failures are handled
            # inside poll): record it so stats tell the operator why
            # the queue stopped draining, instead of silent stranding
            self._record_executor_death(None, exc)

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                # an entry in retry backoff wakes the worker at
                # not_before, not at its (possibly past) deadline
                deadlines = [min(max(e.deadline, e.not_before) for e in g)
                             for g in self._groups.values() if g]
                full = any(sum(e.rows for e in g) >= self.cfg.max_batch
                           for g in self._groups.values())
                if not deadlines:
                    self._cond.wait(timeout=0.1)
                    continue
                wait = min(deadlines) - time.perf_counter()
                if not full and wait > 0:
                    self._cond.wait(timeout=min(wait, 0.05))
                    continue
            try:
                self.poll()
            except Exception:
                # the failing batch's handles were already failed by
                # _execute; the worker must keep serving everyone else
                pass


def mixed_request_stream(corpus, n: int, *, short_len: int = 3,
                         k_pool=(10, 100),
                         query_pool: int | None = None,
                         deadline_ms: float | None = None) -> list:
    """Deterministic real-traffic-shaped demo stream over a synthetic
    corpus: alternate short (``short_len``-term) and full-length rows,
    cycle ``k`` through ``k_pool`` (mixed k-buckets in flight), and
    cycle a ``query_pool``-sized query subset so queries repeat — the
    access pattern the response cache exists for. The single copy the
    serving example and ``benchmarks/serving_bench.py`` both drive, so
    their numbers describe the same workload."""
    qn = min(query_pool or len(corpus.queries), len(corpus.queries))
    reqs = []
    for i in range(n):
        qi = i % qn
        qlen = short_len if i % 2 == 0 else corpus.queries.shape[1]
        reqs.append(SearchRequest(
            terms=corpus.queries[qi, :qlen],
            weights_b=corpus.q_weights_b[qi, :qlen],
            weights_l=corpus.q_weights_l[qi, :qlen],
            k=k_pool[(i // 2) % len(k_pool)],
            deadline_ms=deadline_ms))
    return reqs


def run_workload(scheduler: AsyncRetrievalScheduler,
                 requests: list, qps: float, seed: int = 0,
                 priorities=None) -> dict:
    """Open-loop Poisson driver: submit ``requests`` (SearchRequests) at
    exponential inter-arrival times — single-host serving, the regime
    the paper's MRT/P99 tables use. With no worker running it polls the
    scheduler inline (deterministic sync mode); with ``start()`` active
    (single worker or executor pool) it only submits and then blocks on
    the handles, so dispatch concurrency is whatever the scheduler
    runs. Latency is admission -> completion per handle, so it includes
    batching delay; cache hits complete with zero service time and are
    clamped at 0 (never negative, never NaN, never dropped). Requests
    refused at admission (``SchedulerSaturated``) and load-shed victims
    are excluded from the latency aggregates but appear in the returned
    ``stats()`` counters. Returns latency aggregates plus
    ``scheduler.stats()``, and reports **goodput** next to QPS:
    ``n_in_deadline`` / ``goodput_qps`` count only completions that met
    their own ``deadline_ms`` (every completion, for deadline-free
    requests) — the number that matters when expired work still burns
    batch slots.
    """
    if not requests:
        return {"n": 0, "mrt_ms": math.nan, "p50_ms": math.nan,
                "p99_ms": math.nan, "qps_achieved": 0.0,
                "n_in_deadline": 0, "goodput_qps": 0.0,
                **scheduler.stats()}
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, len(requests)))
    threaded = scheduler.is_running()
    t0 = time.perf_counter()
    handles = []
    i, n = 0, len(requests)
    while i < n or (not threaded and scheduler.pending_count()):
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            pr = 0 if priorities is None else int(priorities[i])
            try:
                handles.append(scheduler.submit(requests[i], priority=pr,
                                                now=t0 + arrivals[i]))
            except SchedulerSaturated:
                pass  # rejected at admission; counted in stats()
            i += 1
        if threaded:
            # the worker(s) dispatch; just pace the arrivals
            if i < n:
                time.sleep(max(0.0,
                               t0 + arrivals[i] - time.perf_counter()))
            continue
        # a failing batch resolves its own handles (and is popped from
        # its group, so draining terminates); one bad route must not
        # abort the measurement for every other request
        try:
            progressed = (scheduler.flush() if i >= n
                          else scheduler.poll())
        except Exception:
            continue
        if i < n and not progressed:
            nxt = t0 + arrivals[i]
            dl = scheduler.next_deadline()
            if dl is not None:
                nxt = min(nxt, dl)
            time.sleep(max(0.0, nxt - time.perf_counter()))
    if threaded:
        for h in handles:
            try:
                h.result(timeout=120.0)
            except Exception:
                pass  # failures/sheds surface via stats and are filtered
    wall = time.perf_counter() - t0
    served = [h.latency_ms for h in handles if h._exception is None]
    n_good = sum(
        1 for h in handles
        if h._exception is None and math.isfinite(h.latency_ms)
        and (h.deadline_ms is None or h.latency_ms <= h.deadline_ms))
    return {**aggregate_latencies(served, wall),
            "n_in_deadline": n_good, "goodput_qps": n_good / wall,
            **scheduler.stats()}
