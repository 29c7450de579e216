"""The port's observability layer (``repro_torch.obs``), on the CPU: the
port of the ``tests/test_obs.py`` tests (all but the bench-JSON guard,
which waits for the port's benchmarks), plus the port's own seams.

Ported (same names, same assertions): exact-rank quantiles and
``aggregate_latencies``, mergeable histograms (with the hypothesis
merge == pooled property), the registry, the span tracer (simulated clock,
bounded ring, zero-cost disabled path), Prometheus/JSON export and the HTTP
server, and the cost model (fit, guards, monotone prediction on a port
index), and the scheduler-bound tests on ``repro_torch.serve``
(``device="cpu"``): queue-wait and service histograms in ``stats()``, the
per-request trace, cached and expired request spans, cost-sorted
dispatch parity, the predictor against realized chunks, the featurizer
reset on a swap. Added: the export's JSON fallback on torch values, the
obs surface loading without torch, ``Retriever.open(metrics=)`` recording
one ``search_ms/<engine>`` sample per search as the reference does, and
``trace_exec`` and ``QueryFeaturizer`` on the port's stats and index
equal to the reference's on its own.
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import build_index as jax_build_index
from repro.core import twolevel as jax_twolevel
from repro.core.traversal import TRACE_STAT_KEYS as JAX_TRACE_STAT_KEYS
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import QueryFeaturizer as JaxFeaturizer
from repro.obs import trace_exec as jax_trace_exec
from repro.retrieval import Retriever as JaxRetriever
from repro_torch.core import build_index, twolevel
from repro_torch.core.traversal import TRACE_STAT_KEYS
from repro_torch.data import make_corpus
from repro_torch.index import compress_index
from repro_torch.obs import (FEATURES, NULL_SPAN, NULL_TRACER, CostModel,
                             Histogram, MetricsRegistry, MetricsServer,
                             NullTracer, QueryFeaturizer, Tracer,
                             aggregate_latencies, exact_quantile,
                             json_snapshot, prometheus_text)
from repro_torch.obs import trace_exec
from repro_torch.retrieval import Retriever, SearchRequest
from repro_torch.serve import (AsyncRetrievalScheduler, SchedulerConfig,
                               single_route)

RANK_SAFE = twolevel.original(gamma=0.2)
SRC = Path(__file__).resolve().parents[1] / "src"

# the scheduler tests run on the CPU; the entry points default to "cuda"
Scheduler = functools.partial(AsyncRetrievalScheduler, device="cpu")


@pytest.fixture(scope="module")
def setup():
    # conftest's small_corpus, built by the port
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    index = build_index(corpus.merged("scaled"), tile_size=256,
                        device="cpu")
    return corpus, index


@pytest.fixture(scope="module")
def reference(small_corpus):
    return small_corpus, jax_build_index(small_corpus.merged("scaled"),
                                         tile_size=256)


# -- exact-rank quantiles -----------------------------------------------------

def test_exact_quantile_is_an_observed_sample():
    # the convention the repo standardizes on: p99 of {1, 3} is 3.0 (a
    # sample), not numpy's interpolated 2.98
    assert exact_quantile([1.0, 3.0], 0.99) == 3.0
    assert exact_quantile([100.0, 50.0], 0.99) == 100.0
    assert exact_quantile([5.0], 0.5) == 5.0
    x = np.arange(1, 101, dtype=np.float64)
    assert exact_quantile(x, 0.5) == 50.0
    assert exact_quantile(x, 0.99) == 99.0
    assert exact_quantile(x, 1.0) == 100.0
    assert exact_quantile(x, 0.0) == 1.0    # clamped to rank 1

def test_exact_quantile_guards():
    assert math.isnan(exact_quantile([], 0.5))
    assert math.isnan(exact_quantile([math.nan, math.inf], 0.99))
    assert exact_quantile([1.0, math.nan, 3.0, math.inf], 0.99) == 3.0


def test_aggregate_latencies_uses_exact_rank():
    agg = aggregate_latencies([1.0, 3.0], wall_s=1.0)
    assert agg["p99_ms"] == 3.0 and agg["p50_ms"] == 1.0
    assert agg["mrt_ms"] == 2.0 and agg["n"] == 2
    empty = aggregate_latencies([math.nan], wall_s=1.0)
    assert empty["n"] == 0 and math.isnan(empty["mrt_ms"])


# -- histograms ---------------------------------------------------------------

def test_histogram_basic_and_bucket_resolution():
    h = Histogram("lat")
    for v in (1.0, 2.0, 3.0, 10.0):
        h.record(v)
    assert h.n == 4
    assert h.mean == pytest.approx(4.0)
    # quantiles are bucket upper edges clamped to [min, max]: within one
    # bucket width (2%) above the exact sample quantile, never below min,
    # and the top rank is exactly the max
    assert h.quantile(1.0) == 10.0
    assert 3.0 <= h.quantile(0.75) <= 3.0 * h.growth
    assert h.quantile(0.0) >= 1.0

def test_histogram_nonpos_bucket_and_empty_summary():
    h = Histogram()
    assert h.summary() == {"n": 0}          # no NaN fields: bench-safe
    assert math.isnan(h.quantile(0.5))
    h.record(0.0)                            # zero-service cache hit
    h.record(0.0)
    h.record(5.0)
    assert h.quantile(0.5) == 0.0
    assert h.quantile(1.0) == 5.0

def test_histogram_record_many_matches_loop():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(1.0, 2.0, size=500)
    a, b = Histogram(), Histogram()
    a.record_many(xs)
    for v in xs:
        b.record(v)
    assert a.state() == b.state()

def test_histogram_merge_equals_pooled():
    """The merge invariant: merge(h1, h2) answers every quantile exactly
    as one histogram fed the pooled samples would."""
    rng = np.random.default_rng(7)
    xs = rng.lognormal(0.0, 1.5, size=300)
    ys = rng.lognormal(2.0, 0.5, size=111)
    h1, h2, pooled = Histogram(), Histogram(), Histogram()
    h1.record_many(xs)
    h2.record_many(ys)
    pooled.record_many(np.concatenate([xs, ys]))
    h1.merge(h2)
    assert h1.n == pooled.n
    assert h1.mean == pytest.approx(pooled.mean)
    for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert h1.quantile(q) == pooled.quantile(q), q

def test_histogram_merge_growth_mismatch_raises():
    with pytest.raises(ValueError, match="growth"):
        Histogram(growth=1.02).merge(Histogram(growth=1.1))

def test_histogram_state_roundtrip():
    h = Histogram("x")
    h.record_many([0.0, 0.5, 7.0, 7.0, 123.4])
    h2 = Histogram.from_state(h.state(), name="x")
    assert h2.state() == h.state()
    for q in (0.2, 0.5, 0.9, 1.0):
        assert h2.quantile(q) == h.quantile(q)


# -- hypothesis generalization (optional dev dependency) ----------------------
# guarded import: the deterministic tests above run without hypothesis

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    def given(*a, **k):  # pragma: no cover - placeholders keep defs valid
        return lambda f: f

    settings, st = given, None

if HAVE_HYPOTHESIS:
    finite = st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                       allow_infinity=False)

    @settings(max_examples=50, deadline=None)
    @given(st.lists(finite, max_size=80), st.lists(finite, max_size=80))
    def test_histogram_merge_pooled_property(xs, ys):
        h1, h2, pooled = Histogram(), Histogram(), Histogram()
        h1.record_many(xs)
        h2.record_many(ys)
        pooled.record_many(xs + ys)
        h1.merge(h2)
        assert h1.n == pooled.n
        for q in (0.1, 0.5, 0.9, 0.99):
            a, b = h1.quantile(q), pooled.quantile(q)
            assert (a == b) or (math.isnan(a) and math.isnan(b))


# -- registry -----------------------------------------------------------------

def test_registry_kinds_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("served").inc(3)
    reg.gauge("depth").set(7.5)
    reg.histogram("lat").record_many([1.0, 2.0])
    snap = reg.snapshot()
    assert snap["counters"]["served"] == 3
    assert snap["gauges"]["depth"] == 7.5
    assert snap["histograms"]["lat"]["n"] == 2
    # a name is permanently one kind
    with pytest.raises(TypeError, match="Counter"):
        reg.histogram("served")
    # same-name lookup returns the same object
    assert reg.counter("served") is reg.counter("served")

def test_registry_merge():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("c").inc(1)
    b.counter("c").inc(2)
    b.gauge("g").set(9.0)
    b.histogram("h").record(4.0)
    a.merge(b)
    snap = a.snapshot()
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == 9.0
    assert snap["histograms"]["h"]["n"] == 1


# -- tracer -------------------------------------------------------------------

def test_span_lifecycle_on_simulated_clock():
    clock = iter([10.0, 12.5])
    tr = Tracer(now=lambda: next(clock))
    s = tr.start("work", foo=1)
    assert math.isnan(s.t_end) and len(tr) == 0   # live spans not in ring
    tr.finish(s)
    assert s.t_start == 10.0 and s.t_end == 12.5
    assert s.duration_ms == pytest.approx(2500.0)
    assert len(tr) == 1
    d = tr.export()[0]
    assert d["name"] == "work" and d["attrs"] == {"foo": 1}

def test_emit_is_retroactive_and_parents_link():
    tr = Tracer()
    root = tr.emit("request", 1.0, 2.0, trace_id=42, route="all")
    child = tr.emit("queue", 1.0, 1.5, trace_id=42, parent=root)
    assert child.parent_id == root.span_id
    spans = tr.trace(42)
    assert [s["name"] for s in spans] == ["request", "queue"]
    assert tr.slowest("request") == 42

def test_ring_eviction_is_deterministic_fifo():
    tr = Tracer(capacity=3)
    for i in range(5):
        tr.emit("s", float(i), float(i) + 0.1, trace_id=i)
    assert [s["trace_id"] for s in tr.export()] == [2, 3, 4]
    tr.clear()
    assert len(tr) == 0
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)

def test_nested_spans_link_to_the_open_span():
    """``span`` without a parent or trace id is the child of this thread's
    innermost open span; an explicit parent or trace id wins; spans on
    another thread do not nest under this one's."""
    clock = iter(float(i) for i in range(100))
    tr = Tracer(now=lambda: next(clock))
    with tr.span("search", rows=2) as root:
        with tr.span("chunk") as chunk:
            with tr.span("gather"):
                pass
        other = tr.emit("request", 0.0, 1.0, trace_id=7)
        with tr.span("copy", parent=other):
            pass
        with tr.span("own", trace_id=9):
            pass

        def alone():
            with tr.span("alone"):
                pass
        th = threading.Thread(target=alone)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    spans = {s["name"]: s for s in tr.export()}
    assert spans["search"]["parent_id"] is None
    assert spans["search"]["attrs"] == {"rows": 2}
    assert spans["chunk"]["parent_id"] == root.span_id
    assert spans["gather"]["parent_id"] == chunk.span_id
    assert {s["trace_id"] for n, s in spans.items()
            if n in ("search", "chunk", "gather")} == {root.trace_id}
    assert (spans["copy"]["parent_id"], spans["copy"]["trace_id"]) == (
        other.span_id, 7)
    assert (spans["own"]["parent_id"], spans["own"]["trace_id"]) == (None, 9)
    assert spans["alone"]["parent_id"] is None
    assert spans["alone"]["trace_id"] != root.trace_id
    # the ring order is the finish order: innermost first
    assert [s["name"] for s in tr.export()][:3] == ["gather", "chunk",
                                                   "request"]


def test_null_tracer_is_free_and_shared():
    assert NULL_TRACER.enabled is False
    assert NULL_TRACER.emit("x", 0.0, 1.0) is NULL_SPAN
    assert NULL_TRACER.start("x") is NULL_SPAN
    assert NULL_SPAN.set(a=1) is NULL_SPAN and NULL_SPAN.attrs == {}
    with NULL_TRACER.span("x") as s:
        assert s is NULL_SPAN
    assert NULL_TRACER.export() == [] and len(NULL_TRACER) == 0
    assert isinstance(NULL_TRACER, NullTracer)
    # one shared context manager, whatever the name and attributes
    assert NULL_TRACER.span("x") is NULL_TRACER.span("y", chunk=3)

def test_disabled_tracer_overhead_guard():
    """The disabled path must stay no-op cheap: one attribute check per
    request plus (at worst) a no-op emit. The bound is deliberately
    generous — it guards against accidentally putting allocation or
    locking on the disabled path, not against scheduler jitter."""
    tr = NULL_TRACER
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        if tr.enabled:  # pragma: no cover - the guarded (never-taken) arm
            tr.emit("request", 0.0, 1.0, big="attrs", would="cost")
    elapsed_check = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        tr.emit("request", 0.0, 1.0)
    elapsed_emit = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("rt.chunk"):    # the search path's per-step cost
            pass
    elapsed_span = time.perf_counter() - t0
    assert elapsed_check / n < 5e-6     # the scheduler's per-delivery cost
    assert elapsed_emit / n < 20e-6
    assert elapsed_span / n < 20e-6


# -- export -------------------------------------------------------------------

def _demo_registry():
    reg = MetricsRegistry()
    reg.counter("batches").inc(4)
    reg.gauge("generation").set(1.0)
    reg.histogram("queue_wait_ms").record_many([1.0, 2.0, 8.0])
    return reg

def test_prometheus_text_format():
    text = prometheus_text(_demo_registry())
    assert "# TYPE repro_batches counter" in text
    assert "repro_batches 4" in text
    assert "# TYPE repro_generation gauge" in text
    assert "# TYPE repro_queue_wait_ms summary" in text
    assert 'repro_queue_wait_ms{quantile="0.5"}' in text
    assert "repro_queue_wait_ms_count 3" in text
    # name sanitization: '/' is not a legal prometheus name char
    reg = MetricsRegistry()
    reg.histogram("search_ms/batched").record(1.0)
    assert "repro_search_ms_batched" in prometheus_text(reg)

def test_json_snapshot_shape():
    tr = Tracer()
    tr.emit("request", 0.0, 0.5, trace_id=9)
    out = json_snapshot(_demo_registry(), tr, extra={"k": 1})
    assert out["metrics"]["counters"]["batches"] == 4
    assert out["traces"] == {"spans": 1, "slowest_request": 9}
    assert out["extra"] == {"k": 1}
    json.dumps(out)   # JSON-able end to end
    # disabled tracer: no traces key
    assert "traces" not in json_snapshot(_demo_registry(), NULL_TRACER)

def test_metrics_server_serves_all_endpoints():
    tr = Tracer()
    # numpy-scalar attr: callers driving the scheduler with numpy clocks
    # leak these into spans — the JSON endpoints must coerce, not 500
    tr.emit("request", 0.0, 1.0, trace_id=1,
            queue_wait_ms=np.float64(3.5))
    with MetricsServer(_demo_registry(), tr,
                       extra=lambda: {"live": True}) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "repro_batches 4" in text
        snap = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
        assert snap["extra"] == {"live": True}
        spans = json.loads(
            urllib.request.urlopen(f"{base}/traces").read())
        assert len(spans) == 1 and spans[0]["name"] == "request"
        assert spans[0]["attrs"]["queue_wait_ms"] == 3.5
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")


# -- cost model ---------------------------------------------------------------

def test_cost_model_fit_recovers_nonneg_linear():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 10.0, size=(400, len(FEATURES)))
    w_true = np.array([2.0, 0.5, 0.0, 1.5, 3.0])
    y = 1.0 + X @ w_true + rng.normal(0.0, 0.05, size=400)
    m = CostModel.fit(X, y)
    assert (m.weights >= 0).all()
    assert m.r2 > 0.99
    assert m.n_samples == 400
    pred = m.predict(X)
    assert np.corrcoef(pred, y)[0, 1] > 0.99

def test_cost_model_guards(tmp_path):
    with pytest.raises(ValueError, match="zero samples"):
        CostModel.fit(np.zeros((0, 5)), [])
    with pytest.raises(ValueError, match="no .*samples"):
        CostModel.fit_from_traces([{"attrs": {"unrelated": 1}}])
    m = CostModel.fit(np.ones((4, 5)), [1.0, 1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="feature width"):
        m.predict(np.ones((2, 3)))
    # persistence round-trip
    p = tmp_path / "cost_model.json"
    m.save(p)
    m2 = CostModel.load(p)
    assert np.allclose(m2.weights, m.weights)
    assert m2.intercept == pytest.approx(m.intercept)
    assert m2.features == m.features


def test_cost_prediction_is_monotone(setup):
    """A heavier query can never predict fewer chunks: every feature is
    nondecreasing under adding a term or increasing a weight, and the
    fitted weights are nonnegative."""
    corpus, index = setup
    feat = QueryFeaturizer(index, RANK_SAFE)
    rng = np.random.default_rng(3)
    X = rng.uniform(0.0, 5.0, size=(200, len(FEATURES)))
    y = 0.5 + X @ np.array([1.0, 2.0, 0.3, 0.7, 1.1])
    model = CostModel.fit(X, y)
    width = 8
    for trial in range(20):
        t = rng.choice(index.sigma_b.shape[0], width,
                       replace=False).astype(np.int32)
        w = rng.uniform(0.1, 2.0, width).astype(np.float32)
        live = rng.integers(2, width - 1)
        base_w = w.copy()
        base_w[live:] = 0.0          # only `live` terms active
        f_base = feat(t[None], base_w[None], base_w[None])
        # (a) add a term
        more_w = w.copy()
        more_w[live + 1:] = 0.0
        f_more = feat(t[None], more_w[None], more_w[None])
        # (b) increase one live weight
        heavier = base_w.copy()
        heavier[0] *= 3.0
        f_heavy = feat(t[None], heavier[None], heavier[None])
        assert (f_more >= f_base - 1e-9).all(), trial
        assert (f_heavy >= f_base - 1e-9).all(), trial
        p = model.predict(np.concatenate([f_base, f_more, f_heavy]))
        assert p[1] >= p[0] - 1e-9
        assert p[2] >= p[0] - 1e-9


def test_sort_without_model_raises(setup):
    corpus, index = setup
    with pytest.raises(ValueError, match="cost_model"):
        Scheduler(index, RANK_SAFE,
                  SchedulerConfig(sort_batches_by_cost=True))


# -- scheduler integration ----------------------------------------------------

def _req(corpus, i, qlen=None, k=10):
    q, wb, wl = (corpus.queries[i], corpus.q_weights_b[i],
                 corpus.q_weights_l[i])
    if qlen is not None:
        q, wb, wl = q[:qlen], wb[:qlen], wl[:qlen]
    return SearchRequest(terms=q, weights_b=wb, weights_l=wl, k=k)


def _chunked_route():
    return single_route("batched", traversal="chunked", chunk_tiles=2)


def _serve(scheduler, corpus, n=10, mixed=True):
    handles = []
    for i in range(n):
        qlen = 3 if (mixed and i % 2 == 0) else None
        handles.append(scheduler.submit(_req(corpus, i % 12, qlen=qlen)))
    scheduler.flush()
    return [h.result(timeout=30.0) for h in handles]

def test_stats_carry_queue_wait_and_service_histograms(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE, SchedulerConfig(max_batch=4, cache_size=0))
    _serve(s, corpus, n=6)
    st = s.stats()
    assert st["queue_wait_ms"]["n"] == 6     # one sample per request
    assert st["service_ms"]["n"] == st["batches"]
    assert st["queue_wait_ms"]["p99"] >= st["queue_wait_ms"]["p50"] >= 0.0
    # the snapshot-consistency invariant stays intact with the new keys
    assert st["submitted"] == (st["completed"] + st["failed"] + st["shed"]
                               + st["rejected"] + st["expired"]
                               + st["pending"] + st["in_flight"])

def test_one_trace_explains_a_slow_request(setup):
    """The acceptance trace: with tracing on, a single exported trace
    shows the queue wait, the batch token, the executor id, and the
    traversal's chunks_dispatched."""
    corpus, index = setup
    tracer = Tracer()
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, tracer=tracer),
        routing=_chunked_route())
    _serve(s, corpus, n=8)
    trace_id = tracer.slowest("request")
    assert trace_id is not None
    spans = {sp["name"]: sp for sp in tracer.trace(trace_id)}
    assert set(spans) == {"request", "queue", "execute"}
    assert spans["queue"]["attrs"]["queue_wait_ms"] >= 0.0
    ex = spans["execute"]["attrs"]
    assert isinstance(ex["batch"], int)
    assert ex["executor"] == -1              # sync dispatch: no pool slot
    assert ex["chunks_dispatched"] >= 1.0
    assert ex["n_chunks"] >= ex["chunks_dispatched"]
    assert len(ex["cost_features"]) == len(FEATURES)
    # children link to the root request span
    root_id = spans["request"]["span_id"]
    assert spans["queue"]["parent_id"] == root_id
    assert spans["execute"]["parent_id"] == root_id

def test_cached_hits_and_expiries_emit_request_spans(setup):
    corpus, index = setup
    tracer = Tracer()
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=16, tracer=tracer))
    h1 = s.submit(_req(corpus, 0))
    s.flush()
    h1.result(timeout=30.0)
    h2 = s.submit(_req(corpus, 0))
    assert h2.result(timeout=30.0) is not None and h2.cached
    outcomes = [sp["attrs"].get("outcome") for sp in tracer.export()
                if sp["name"] == "request"]
    assert outcomes.count("completed") == 1
    assert outcomes.count("cached") == 1
    # expiry: a dead-on-arrival deadline sheds at pick time with a span
    h3 = s.submit(SearchRequest(terms=corpus.queries[1],
                                weights_b=corpus.q_weights_b[1],
                                weights_l=corpus.q_weights_l[1],
                                k=10, deadline_ms=1e-6))
    time.sleep(0.002)
    s.flush()
    with pytest.raises(Exception):
        h3.result(timeout=5.0)
    expired = [sp for sp in tracer.export()
               if sp["attrs"].get("outcome") == "expired"]
    assert len(expired) == 1

def test_cost_sorted_dispatch_is_bit_identical(setup):
    """The parity acceptance: per-query results are batch-composition
    independent, so cost-sorted dispatch returns bit-identical
    ids/scores to unsorted dispatch for every request."""
    corpus, index = setup
    # fit a model from a traced run over the same route
    tracer = Tracer()
    traced = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, tracer=tracer),
        routing=_chunked_route())
    _serve(traced, corpus, n=10)
    model = CostModel.fit_from_traces(tracer.export())
    assert (model.weights >= 0).all()

    def responses(sort):
        s = Scheduler(
            index, RANK_SAFE,
            SchedulerConfig(max_batch=4, cache_size=0,
                            cost_model=model if sort else None,
                            sort_batches_by_cost=sort),
            routing=_chunked_route())
        return _serve(s, corpus, n=10)

    plain, sorted_ = responses(False), responses(True)
    for a, b in zip(plain, sorted_):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)

def test_predictor_tracks_realized_chunks(setup):
    """Fit from one traced run, predict on a second: predicted chunk
    counts must correlate with realized chunks_dispatched (the mixed
    short/long stream spans a real cost range)."""
    corpus, index = setup
    tracer = Tracer()
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, tracer=tracer),
        routing=_chunked_route())
    _serve(s, corpus, n=12)
    spans = tracer.export()
    model = CostModel.fit_from_traces(spans)
    X, y = [], []
    for sp in spans:
        attrs = sp["attrs"]
        if "cost_features" in attrs and "chunks_dispatched" in attrs:
            X.append(attrs["cost_features"])
            y.append(attrs["chunks_dispatched"])
    assert len(y) >= 10
    pred = model.predict(np.asarray(X))
    y = np.asarray(y)
    if y.std() > 0 and pred.std() > 0:
        assert np.corrcoef(pred, y)[0, 1] > 0.5
    else:                     # degenerate corpus: constant chunk counts
        assert np.allclose(pred, pred[0])

def test_featurizer_resets_on_swap(setup):
    corpus, index = setup
    tracer = Tracer()
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, tracer=tracer))
    _serve(s, corpus, n=2)
    assert s._featurizer is not None
    s.swap_index(index, warm=False)
    assert s._featurizer is None


# -- the port's seams ---------------------------------------------------------

def test_json_fallback_turns_torch_values_into_numbers():
    """Span attributes holding a 0-d tensor, a tensor of several elements
    or a numpy scalar serialize through ``/traces`` and ``/metrics.json``
    as Python numbers and lists, not as a 500."""
    tr = Tracer()
    tr.emit("request", 0.0, 1.0, trace_id=1, ms=torch.tensor(2.5),
            chunks=torch.tensor([3.0, 4.0]), n=np.int64(7))
    with MetricsServer(MetricsRegistry(), tr,
                       extra=lambda: {"busy": torch.tensor(0.25)}) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        spans = json.loads(urllib.request.urlopen(f"{base}/traces").read())
        snap = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
    assert spans[0]["attrs"] == {"ms": 2.5, "chunks": [3.0, 4.0], "n": 7}
    assert snap["extra"] == {"busy": 0.25}


def test_obs_surface_loads_without_torch(tmp_path):
    """``repro_torch.obs`` (metrics, spans, export, cost) imports and runs
    with ``torch``, ``jax`` and ``repro`` unimportable; ``trace_exec``,
    which reads the traversal's stat keys, is the one module that needs
    torch, and ``Tracer(profile=True)`` the one tracer."""
    script = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        from repro_torch.obs import MetricsRegistry, Tracer, prometheus_text
        reg = MetricsRegistry()
        reg.histogram("search_ms/kernel").record_many([1.0, 2.0])
        assert "repro_search_ms_kernel_count 2" in prometheus_text(reg)
        Tracer().emit("request", 0.0, 1.0)
        with Tracer().span("search") as span:
            span.set(rows=1)
        try:
            Tracer(profile=True)     # a profiler range needs torch
        except ImportError:
            pass
        else:
            raise SystemExit("Tracer(profile=True) loaded without torch")
        try:
            import repro_torch.obs.trace_exec
        except ImportError:
            print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("kernel", {"traversal": "chunked_fused",
                                 "chunk_tiles": 2})])
def test_retriever_records_one_search_ms_sample_per_search(
        setup, reference, engine, opts):
    """``Retriever.open(..., metrics=reg)`` records each search's wall
    time into ``search_ms/<engine>``, one sample per search, as the
    reference's does; a replica shares the registry; a retriever opened
    without one records nothing."""
    corpus, index = setup
    jcorpus, jindex = reference
    q = dict(terms=corpus.queries[:4], weights_b=corpus.q_weights_b[:4],
             weights_l=corpus.q_weights_l[:4])
    reg, jreg = MetricsRegistry(), JaxRegistry()
    r = Retriever.open(index, twolevel.fast(), engine=engine, device="cpu",
                       metrics=reg, **opts)
    jr = JaxRetriever.open(jindex, jax_twolevel.fast(), engine=engine,
                           metrics=jreg, **opts)
    for k in (10, 100, 10):
        r.search(**q, k=k)
        jr.search(**q, k=k)
    r.replicate().search(**q, k=10)
    jr.replicate().search(**q, k=10)
    name = f"search_ms/{engine}"
    assert set(reg.snapshot()["histograms"]) == set(
        jreg.snapshot()["histograms"]) == {name}
    assert reg.histogram(name).n == jreg.histogram(name).n == 4
    summary = reg.snapshot()["histograms"][name]
    assert 0.0 < summary["min"] <= summary["p50"] <= summary["max"]
    plain = Retriever.open(index, twolevel.fast(), engine=engine,
                           device="cpu", **opts)
    assert plain.metrics is None and plain._hist_search is None


# the parent of each of the search path's spans (``rt.chunk``'s steps sit
# under ``rt.search`` in the full scan, which has no chunk loop)
SEARCH_PARENTS = {"rt.search": None, "rt.pad": "rt.search",
                  "rt.upload": "rt.search", "rt.plan": "rt.search",
                  "rt.chunk.test": "rt.search", "rt.chunk": "rt.search",
                  "rt.copy": "rt.search",
                  **{f"rt.chunk.{step}": "rt.chunk" for step in (
                      "gather", "score", "counts", "select", "merge")}}


def _profiled(fn):
    """``fn()`` under the profiler (host only): its result and the names
    and [start, end] of the profile's ``rt.`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("rt.")]
    return out, ranges


@pytest.mark.parametrize("engine,opts,kind", [
    ("kernel", {"traversal": "chunked_fused", "chunk_tiles": 1}, "fp32"),
    ("kernel", {"traversal": "chunked_fused", "chunk_tiles": 1}, "q8"),
    ("batched", {"traversal": "chunked", "chunk_tiles": 1}, "fp32"),
    ("batched", {}, "fp32")])
def test_search_spans_nest_on_the_profiler_timeline(setup, engine, opts,
                                                    kind):
    """A search with ``Tracer(profile=True)`` under the profiler: each span
    is a profiler range of its name, nested as the ring's parents say; one
    ``rt.chunk`` per dispatched chunk (the loop's last, failing test has
    none); ids, scores and stats bit-equal to the untraced search, which
    opens no range at all."""
    corpus, index = setup
    if kind == "q8":
        index = compress_index(corpus.merged("scaled"), tile_size=256,
                               device="cpu")
    rows = (2, 3, 4, 5, 8)            # the loop stops before the last chunk
    q = dict(terms=[corpus.queries[i][:3 + i % 3] for i in rows],
             weights_b=[corpus.q_weights_b[i][:3 + i % 3] for i in rows],
             weights_l=[corpus.q_weights_l[i][:3 + i % 3] for i in rows],
             k=10, threshold_factor=2.0)
    plain = Retriever.open(index, twolevel.fast(), engine=engine,
                           device="cpu", **opts)
    tracer = Tracer(profile=True)
    traced = Retriever.open(index, twolevel.fast(), engine=engine,
                            device="cpu", tracer=tracer, **opts)
    ref, none = _profiled(lambda: plain.search(**q))
    got, ranges = _profiled(lambda: traced.search(**q))
    assert none == []
    np.testing.assert_array_equal(got.ids, ref.ids)
    np.testing.assert_array_equal(got.scores, ref.scores)
    assert got.stats.keys() == ref.stats.keys()
    for key in ref.stats:
        np.testing.assert_array_equal(got.stats[key], ref.stats[key])

    spans = tracer.export()
    by_id = {sp["span_id"]: sp for sp in spans}
    parents = {sp["name"]: (by_id[sp["parent_id"]]["name"]
                            if sp["parent_id"] is not None else None)
               for sp in spans}
    chunked = "traversal" in opts
    want = SEARCH_PARENTS if chunked else {
        n: ("rt.search" if p == "rt.chunk" else p)
        for n, p in SEARCH_PARENTS.items()
        if n not in ("rt.chunk", "rt.chunk.test")}
    assert parents == want
    assert len({sp["trace_id"] for sp in spans}) == 1
    names = [sp["name"] for sp in spans]
    assert sorted(n for n, _, _ in ranges) == sorted(names)
    # the profiler's ranges nest as the ring's parents say
    for name, s, e in ranges:
        parent = want[name]
        if parent is not None:
            assert any(n == parent and ps <= s and e <= pe
                       for n, ps, pe in ranges), name
    root, = (sp for sp in spans if sp["name"] == "rt.search")
    dispatched = int(ref.stats["chunks_dispatched"].max()) if chunked else 0
    assert root["attrs"] == {"rows": len(rows), "width": 5,
                             "terms": sum(3 + i % 3 for i in rows), "k": 10,
                             **({"chunks": dispatched} if chunked else {})}
    if chunked:
        assert names.count("rt.chunk") == dispatched
        assert 0 < dispatched < ref.stats["n_chunks"][0]
        assert names.count("rt.chunk.test") == dispatched + 1
        assert [sp["attrs"]["chunk"] for sp in spans
                if sp["name"] == "rt.chunk"] == list(range(dispatched))


@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("batched", {"traversal": "chunked", "chunk_tiles": 2}),
    ("kernel", {"traversal": "chunked_fused", "chunk_tiles": 2})])
def test_trace_attributes_match_reference(setup, reference, engine, opts):
    """``request_attributes`` on the port's stats equals the reference's
    on its stats, for the same queries on the same corpus: a full scan (no
    chunk keys) and both chunked traversals."""
    assert TRACE_STAT_KEYS == JAX_TRACE_STAT_KEYS
    corpus, index = setup
    _, jindex = reference
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l, k=10)
    port = Retriever.open(index, twolevel.fast(), engine=engine,
                          device="cpu", **opts).search(**q)
    ref = JaxRetriever.open(jindex, jax_twolevel.fast(), engine=engine,
                            **opts).search(**q)
    got = trace_exec.request_attributes(port.stats)
    assert got == jax_trace_exec.request_attributes(ref.stats)
    assert ("chunks_dispatched" in got) == ("traversal" in opts)
    assert (trace_exec.request_attributes(port.stats, reduce=np.mean)
            == jax_trace_exec.request_attributes(ref.stats, reduce=np.mean))


@pytest.mark.parametrize("kind", ["fp32", "q8"])
def test_query_featurizer_matches_reference(setup, reference, kind):
    """``QueryFeaturizer`` on a port index (tensors) gives the reference
    featurizer's features on the reference index, for padded query rows
    and at two alphas."""
    corpus, index = setup
    _, jindex = reference
    if kind == "q8":
        index = compress_index(corpus.merged("scaled"), tile_size=256,
                               device="cpu")
    rows = (corpus.queries, corpus.q_weights_b, corpus.q_weights_l)
    padded = [np.pad(a, ((0, 0), (0, 3))) for a in rows]
    for params, jparams in ((twolevel.fast(), jax_twolevel.fast()),
                            (RANK_SAFE, jax_twolevel.original(gamma=0.2))):
        feat = QueryFeaturizer(index, params)
        jfeat = JaxFeaturizer(jindex, jparams)
        assert feat.theta_ref == jfeat.theta_ref
        for args in (rows, padded):
            np.testing.assert_array_equal(feat(*args), jfeat(*args))
        t = [torch.from_numpy(a) for a in rows]
        np.testing.assert_array_equal(feat(*t), jfeat(*rows))
