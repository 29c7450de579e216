"""The port's observability layer (``repro_torch.obs``), on the CPU: the
port of the ``tests/test_obs.py`` tests that need no scheduler, plus the
port's own seams.

Ported (same names, same assertions): exact-rank quantiles and
``aggregate_latencies``, mergeable histograms (with the hypothesis
merge == pooled property), the registry, the span tracer (simulated clock,
bounded ring, zero-cost disabled path), Prometheus/JSON export and the HTTP
server, and the cost model (fit, guards, monotone prediction on a port
index). Added: the export's JSON fallback on torch values, the obs surface
loading without torch, ``Retriever.open(metrics=)`` recording one
``search_ms/<engine>`` sample per search as the reference does, and
``trace_exec`` and ``QueryFeaturizer`` on the port's stats and index
equal to the reference's on its own. The scheduler-bound tests wait for
the serving port.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
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
from repro_torch.retrieval import Retriever

RANK_SAFE = twolevel.original(gamma=0.2)
SRC = Path(__file__).resolve().parents[1] / "src"


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

def test_null_tracer_is_free_and_shared():
    assert NULL_TRACER.enabled is False
    assert NULL_TRACER.emit("x", 0.0, 1.0) is NULL_SPAN
    assert NULL_TRACER.start("x") is NULL_SPAN
    assert NULL_SPAN.set(a=1) is NULL_SPAN and NULL_SPAN.attrs == {}
    with NULL_TRACER.span("x") as s:
        assert s is NULL_SPAN
    assert NULL_TRACER.export() == [] and len(NULL_TRACER) == 0
    assert isinstance(NULL_TRACER, NullTracer)

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
    assert elapsed_check / n < 5e-6     # the scheduler's per-delivery cost
    assert elapsed_emit / n < 20e-6


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
    torch."""
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


@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("batched", {"traversal": "chunked", "chunk_tiles": 2}),
    ("kernel", {"traversal": "chunked_fused", "chunk_tiles": 2})])
def test_trace_attributes_match_reference(setup, reference, engine, opts):
    """``request_attributes`` and ``row_attributes`` on the port's stats
    equal the reference's on its stats, for the same queries on the same
    corpus: a full scan (no chunk keys) and both chunked traversals."""
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
    for row in (0, 5, len(corpus.queries) - 1, len(corpus.queries)):
        assert (trace_exec.row_attributes(port.stats, row)
                == jax_trace_exec.row_attributes(ref.stats, row))


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
