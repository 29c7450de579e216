"""Query-length routing for the serving scheduler (paper Table 8).

The paper's Appendix-B finding: the best traversal variant depends on
query length — short queries skip more and prefer a finer skip grid
(VBMW-flavored / small chunks), long queries amortize better over larger
blocks (MaxScore-flavored / bigger chunks, or the fused kernel). Our
chunked executor exposes exactly that dial (``chunk_tiles``), so routing
is declarative: a :class:`RoutingPolicy` is an ordered tuple of
:class:`Route` length classes, each naming an engine configuration from
the ``repro_torch.retrieval`` registry.

    policy = RoutingPolicy((
        route("short", max_query_len=4, engine="batched",
              traversal="chunked", chunk_tiles=2),
        route("long", engine="batched", traversal="chunked",
              chunk_tiles=16),
    ))
    policy.classify(3).name   # "short"

``classify`` walks the routes in order and picks the first whose
``max_query_len`` (inclusive) admits the query; the final route must be
the catch-all (``max_query_len=None``). Query length is the number of
*live* terms — terms with a nonzero query weight — so zero-weight
padding never changes a request's class.

The scheduler opens one ``Retriever`` per route (lazily) and keys its
micro-batches and response cache on the route name, so a policy also
fixes the serving grid: one padded batch shape per
(k-bucket x length-class).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .health import RetryPolicy


@dataclasses.dataclass(frozen=True)
class Route:
    """One length class -> one engine configuration.

    ``pad_terms`` overrides the scheduler's static query width for this
    class: a short class executing at a narrow width skips the masked
    compute the global width would spend on its padding terms — on the
    batched engines the planner/gather cost scales with the padded
    width, so this is where length routing pays most (queries longer
    than the width keep their highest-impact terms, as always).

    ``retry`` overrides the scheduler-wide :class:`RetryPolicy` for
    failed batch executions of this class; ``fallback`` names a
    *fallback lane* (a route from ``RoutingPolicy.fallback_routes``)
    the scheduler rewrites to while the pool is degraded — the cheaper
    engine serves, and the responses come back ``degraded=True``.

    ``engine_opts`` is a sorted (key, value) tuple so the Route stays
    hashable; build routes with :func:`route` to pass them as kwargs.
    """
    name: str
    max_query_len: int | None = None   # inclusive; None = catch-all
    engine: str = "batched"
    engine_opts: tuple = ()
    pad_terms: int | None = None       # None -> SchedulerConfig.pad_terms
    retry: RetryPolicy | None = None   # None -> SchedulerConfig.retry
    fallback: str | None = None        # degraded-mode lane (route name)

    def opts(self) -> dict:
        return dict(self.engine_opts)

    def admits(self, query_len: int) -> bool:
        return self.max_query_len is None or query_len <= self.max_query_len


def route(name: str, max_query_len: int | None = None,
          engine: str = "batched", pad_terms: int | None = None,
          retry: RetryPolicy | None = None, fallback: str | None = None,
          **engine_opts) -> Route:
    """Declarative Route builder: kwargs become engine constructor opts
    (``traversal=``, ``chunk_tiles=``, ``n_shards=``, ...)."""
    return Route(name, max_query_len, engine,
                 tuple(sorted(engine_opts.items())), pad_terms,
                 retry, fallback)


@dataclasses.dataclass(frozen=True)
class RoutingPolicy:
    """Ordered length classes; the last route must be the catch-all.

    ``fallback_routes`` are extra lanes that ``classify`` never picks —
    they only serve as ``Route.fallback`` targets while the pool is
    degraded. Keeping them out of ``routes`` means they don't have to
    satisfy the catch-all/ascending-bounds ordering, but they are still
    opened, warmed, and replicated like any primary route.
    """
    routes: tuple[Route, ...]
    fallback_routes: tuple[Route, ...] = ()

    def __post_init__(self):
        if not self.routes:
            raise ValueError("RoutingPolicy needs at least one route")
        names = [r.name for r in self.all_routes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate route names: {names}")
        if self.routes[-1].max_query_len is not None:
            raise ValueError(
                "the last route must be the catch-all "
                "(max_query_len=None); got "
                f"max_query_len={self.routes[-1].max_query_len}")
        bounds = [r.max_query_len for r in self.routes[:-1]]
        if any(b is None for b in bounds):
            raise ValueError("only the last route may be the catch-all")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"route max_query_len bounds must strictly ascend: {bounds}")
        by_name = {r.name: r for r in self.all_routes}
        for r in self.all_routes:
            if r.fallback is None:
                continue
            target = by_name.get(r.fallback)
            if target is None:
                raise ValueError(
                    f"route {r.name!r} falls back to unknown route "
                    f"{r.fallback!r}; routes: {sorted(by_name)}")
            if target.fallback is not None:
                raise ValueError(
                    f"fallback chains are not allowed: {r.name!r} -> "
                    f"{target.name!r} -> {target.fallback!r}")
            if target.pad_terms != r.pad_terms:
                # the fallback executes the *same padded batches*, so a
                # width mismatch would silently re-pad them
                raise ValueError(
                    f"fallback route {target.name!r} must share "
                    f"pad_terms with {r.name!r} "
                    f"({target.pad_terms} != {r.pad_terms})")

    @property
    def all_routes(self) -> tuple[Route, ...]:
        """Primary + fallback lanes — what warmup/replication iterate."""
        return self.routes + self.fallback_routes

    def classify(self, query_len: int) -> Route:
        """First route admitting ``query_len`` (the catch-all always does)."""
        for r in self.routes:
            if r.admits(query_len):
                return r
        raise AssertionError("unreachable: catch-all route admits all")

    def by_name(self, name: str) -> Route:
        for r in self.all_routes:
            if r.name == name:
                return r
        raise KeyError(f"no route named {name!r}; routes: "
                       f"{[r.name for r in self.all_routes]}")

    def fingerprint(self, params) -> str:
        """Stable policy hash: routes + pruning policy. Part of every
        response-cache key, so two schedulers sharing a cache (or one
        scheduler after a policy swap) can never alias entries."""
        blob = repr((self.routes, self.fallback_routes, params)).encode()
        return hashlib.sha1(blob).hexdigest()[:16]


def warmup_grid(policy: RoutingPolicy, k_buckets,
                default_pad_terms: int) -> tuple:
    """The serving grid: one ``(route, width, k_bucket)`` cell per
    (length-class x k-bucket) pair, with the static query width that
    class executes at. Executor warmup runs one zero-weight no-op batch
    per cell, so the first real request of any group never pays a first
    call's set-up (on a GPU: the kernel build and the allocator's first
    blocks); the tests pin the warmup's search count to
    ``len(warmup_grid(...))``."""
    buckets = tuple(k_buckets) if k_buckets else ()
    return tuple(
        (r, r.pad_terms if r.pad_terms is not None else default_pad_terms, b)
        for r in policy.all_routes for b in buckets)


def query_length(weights_b, weights_l) -> int:
    """Live-term count of one query: terms whose combined weight is
    nonzero (zero-weight padding scores as a no-op everywhere)."""
    wb = np.asarray(weights_b)
    wl = np.asarray(weights_l)
    return int(((wb != 0) | (wl != 0)).sum())


def policy_summary(policy: RoutingPolicy) -> dict:
    """A JSON-able description of a routing policy — what the metrics
    endpoint and bench meta embed so a recorded run says which lanes it
    ran. Non-JSON engine opt values (retry policies, callables) render
    as ``repr``."""
    def _jsonable(v):
        return v if isinstance(v, (str, int, float, bool,
                                   type(None))) else repr(v)

    def _route(r: Route) -> dict:
        return {"max_query_len": r.max_query_len, "engine": r.engine,
                "opts": {k: _jsonable(v) for k, v in r.opts().items()},
                "pad_terms": r.pad_terms, "fallback": r.fallback}

    return {"routes": {r.name: _route(r) for r in policy.routes},
            "fallback_routes": {r.name: _route(r)
                                for r in policy.fallback_routes}}


def single_route(engine: str = "batched", **engine_opts) -> RoutingPolicy:
    """The no-routing policy: one catch-all class (what the deprecated
    ``RetrievalServer`` shim uses)."""
    return RoutingPolicy((route("all", None, engine, **engine_opts),))


def table8_policy(short_max_len: int = 4,
                  short_chunk_tiles: int = 2,
                  long_engine: str = "batched",
                  long_traversal: str = "full",
                  **common_opts) -> RoutingPolicy:
    """The Table-8 routing suggestion on our knobs: short queries run at
    a narrow static width (``pad_terms=short_max_len``) through the
    chunked executor's fine exit grid — short queries skip the most, so
    they get the finest-grained early exit *and* none of the masked
    compute a wide padded shape would spend on them. Long queries keep
    the full width on the plain batched scan by default; pass
    ``long_engine="kernel"`` (and ``long_traversal="chunked"`` /
    ``"chunked_fused"``) for the guided-score kernels on a GPU."""
    # "full" is every engine's default traversal — omitting it keeps the
    # long route valid for engines without a traversal knob (sequential)
    long_opts = ({} if long_traversal == "full"
                 else {"traversal": long_traversal})
    return RoutingPolicy((
        route("short", short_max_len, "batched",
              pad_terms=short_max_len, traversal="chunked",
              chunk_tiles=short_chunk_tiles, **common_opts),
        route("long", None, long_engine, **long_opts, **common_opts),
    ))
