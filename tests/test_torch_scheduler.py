"""The port's serving seam (``repro_torch.serve``), on the CPU: the
``tests/test_scheduler.py`` suite on the port (same names, same
assertions), with every scheduler, server and retriever on
``device="cpu"``.

AsyncRetrievalScheduler handle lifecycle, (k-bucket x length-class)
micro-batching with per-request k, the one-shape-per-group guarantee,
query-length routing, the LRU response cache (zero-service-time
completions), priorities, the threaded mode, run_workload accounting,
and the deprecated RetrievalServer shim. The mixed-stream parity runs on
the ``batched`` and ``kernel`` engines; its ``sharded`` case waits for
the port's sharded engine. The port compiles nothing, so the
compile-once test counts searches and opened retrievers instead of jit
cache entries (its docstring says how). Added: the default ``"cuda"``
raises without a GPU, and tensor request fields serve as their numpy
twins do.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.retrieval import Retriever, SearchRequest
from repro_torch.serve import (AsyncRetrievalScheduler, Request,
                               RetrievalServer, RoutingPolicy,
                               SchedulerConfig, ServerConfig, query_length,
                               route, run_workload, single_route,
                               table8_policy)

RANK_SAFE = twolevel.original(gamma=0.2)
SHORT, LONG = 3, 5   # live-term counts in the small_corpus stream

# the suites run on the CPU; the entry points default to "cuda"
Scheduler = functools.partial(AsyncRetrievalScheduler, device="cpu")
Server = functools.partial(RetrievalServer, device="cpu")
open_retriever = functools.partial(Retriever.open, device="cpu")


@pytest.fixture(scope="module")
def setup():
    # conftest's small_corpus, built by the port
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    index = build_index(corpus.merged("scaled"), tile_size=256,
                        device="cpu")
    return corpus, index


def _req(corpus, i, qlen=None, k=10, threshold_factor=None):
    q, wb, wl = (corpus.queries[i], corpus.q_weights_b[i],
                 corpus.q_weights_l[i])
    if qlen is not None:
        q, wb, wl = q[:qlen], wb[:qlen], wl[:qlen]
    return SearchRequest(terms=q, weights_b=wb, weights_l=wl, k=k,
                         threshold_factor=threshold_factor)


def _two_class_policy(engine, **opts):
    return RoutingPolicy((
        route("short", SHORT, engine, pad_terms=SHORT, **opts),
        route("long", None, engine, **opts)))


# -- handle lifecycle ---------------------------------------------------------

def test_handle_lifecycle_sync(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    h = s.submit(_req(corpus, 0, k=7))
    assert not h.done()
    assert math.isnan(h.latency_ms)
    assert s.pending_count() == 1
    assert h.k_bucket == 10 and h.route == "all"
    assert s.flush() == 1
    assert h.done() and s.pending_count() == 0
    resp = h.result()
    assert resp.ids.shape == resp.scores.shape == (1, 7)
    assert resp.ks.tolist() == [7] and resp.k_exec == 10
    assert h.latency_ms >= 0 and not h.cached


def test_result_on_sync_scheduler_flushes_instead_of_deadlocking(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE, SchedulerConfig())
    h = s.submit(_req(corpus, 1))
    resp = h.result(timeout=120.0)   # no worker, no explicit poll
    assert resp.ids.shape == (1, 10)


def test_submit_guards(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE)
    with pytest.raises(TypeError, match="not both"):
        s.submit(_req(corpus, 0), k=5)
    with pytest.raises(ValueError, match="dense"):
        s.submit(SearchRequest(dense=np.zeros((1, 4), np.float32)))
    with pytest.raises(ValueError, match="terms"):
        s.submit(SearchRequest())
    with pytest.raises(ValueError, match="zero-row"):
        s.submit(SearchRequest(terms=np.zeros((0, 5), np.int32),
                               weights_b=np.zeros((0, 5), np.float32),
                               weights_l=np.zeros((0, 5), np.float32)))


def test_zero_term_request_serves_as_noop_row(setup):
    """A 0-term query (everything filtered upstream) pads to an
    all-zero-weight row and returns the empty-queue sentinels — the
    historical server behavior, not a crash."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=0))
    h = s.submit(terms=np.zeros(0, np.int32),
                 weights_b=np.zeros(0, np.float32),
                 weights_l=np.zeros(0, np.float32), k=10)
    s.flush()
    resp = h.result()
    assert resp.ids.shape == (1, 10)
    assert not np.isnan(resp.scores).any()


def test_cache_entries_are_isolated_from_consumer_mutation(setup):
    """Mutating a delivered response (hit or miss) must not corrupt the
    cached entry other requests will be served from."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=8))
    h1 = s.submit(_req(corpus, 0))
    s.flush()
    expect = h1.result().ids.copy()
    expect_tiles = h1.result().stats["tiles_visited"].copy()
    h1.result().ids[:] = -7                  # consumer scribbles (miss path)
    h1.result().ks[:] = 1
    tiles = h1.result().stats["tiles_visited"]
    if tiles.flags.writeable:                # read-only is isolation too
        tiles[:] = -1.0
    h2 = s.submit(_req(corpus, 0))
    assert h2.cached
    np.testing.assert_array_equal(h2.result().ids, expect)
    np.testing.assert_array_equal(h2.result().ks, [10])
    np.testing.assert_array_equal(h2.result().stats["tiles_visited"],
                                  expect_tiles)
    h2.result().ids[:] = -8                  # consumer scribbles (hit path)
    h2.result().ks[:] = 2
    h3 = s.submit(_req(corpus, 0))
    np.testing.assert_array_equal(h3.result().ids, expect)
    np.testing.assert_array_equal(h3.result().ks, [10])


def test_oversized_request_rejected_at_submit(setup):
    """A multi-row request larger than max_batch would run a batch shape
    outside the serving grid; the scheduler refuses it up front."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE, SchedulerConfig(max_batch=2))
    with pytest.raises(ValueError, match="max_batch"):
        s.submit(SearchRequest(terms=corpus.queries[:3],
                               weights_b=corpus.q_weights_b[:3],
                               weights_l=corpus.q_weights_l[:3], k=10))


def test_batch_failure_fails_handles_instead_of_hanging(setup):
    """A dispatch-time error (here: a bad engine opt surfacing at lazy
    Retriever.open) must resolve the affected handles with the
    exception, not strand them forever."""
    corpus, index = setup
    policy = RoutingPolicy((route("all", None, "batched", bogus_opt=1),))
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=0),
                  routing=policy)
    h = s.submit(_req(corpus, 0))
    with pytest.raises(TypeError, match="bogus_opt"):
        s.flush()
    assert h.done()
    with pytest.raises(TypeError, match="bogus_opt"):
        h.result()
    assert s.stats()["failed"] == 1 and s.stats()["completed"] == 0


# -- the acceptance parity: mixed-k, mixed-length stream ----------------------

@pytest.mark.parametrize("engine,opts", [("batched", {}), ("kernel", {})])
def test_mixed_stream_matches_per_request_calls(setup, engine, opts):
    """Every handle of a mixed-k (5/10/100), mixed-length (3/5-term)
    stream resolves to exactly what a per-request Retriever.search on
    the serving route's engine configuration returns (rank-safe)."""
    corpus, index = setup
    policy = _two_class_policy(engine, **opts)
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, pad_terms=LONG, cache_size=0),
        routing=policy)
    stream = [(i, (SHORT, LONG)[i % 2], (5, 10, 100)[i % 3])
              for i in range(12)]
    handles = [s.submit(_req(corpus, i, qlen, k)) for i, qlen, k in stream]
    s.flush()
    refs = {}
    for h, (i, qlen, k) in zip(handles, stream):
        assert h.route == ("short" if qlen == SHORT else "long")
        resp = h.result()
        if h.route not in refs:
            rt = policy.by_name(h.route)
            refs[h.route] = open_retriever(index, RANK_SAFE,
                                           engine=rt.engine, **rt.opts())
        ref = refs[h.route].search(
            terms=corpus.queries[i:i + 1, :qlen],
            weights_b=corpus.q_weights_b[i:i + 1, :qlen],
            weights_l=corpus.q_weights_l[i:i + 1, :qlen], k=k)
        np.testing.assert_array_equal(resp.ids, ref.ids,
                                      err_msg=f"{engine} req {i}")
        np.testing.assert_array_equal(resp.scores, ref.scores,
                                      err_msg=f"{engine} req {i}")


def test_one_compile_per_bucket_times_class(setup):
    """Batches of any fill level run their (k-bucket x length-class)
    group's one padded shape and open nothing new. The JAX package pins
    this as jit cache entries; the port compiles nothing (no
    ``torch.compile``, no CUDA graphs), so here it is pinned by what the
    cache entries stood for: every later flush runs exactly one search
    (the scheduler registry's ``search_ms/<engine>`` histogram counts
    them) at ``[max_batch, width]``, on the Retrievers already open."""
    corpus, index = setup
    s = Scheduler(
        index, twolevel.fast(),
        SchedulerConfig(max_batch=4, pad_terms=LONG, cache_size=0),
        routing=_two_class_policy("batched"))
    # warm all four (bucket x class) groups with full batches
    for i in range(8):
        qlen = SHORT if i % 2 == 0 else LONG
        s.submit(_req(corpus, i, qlen, k=10 if i < 4 else 100))
    s.flush()
    opened = dict(s._retrievers)
    shapes = []
    for name, retr in opened.items():
        search = retr.search

        def recording(*a, _search=search, _name=name, **kw):
            shapes.append((_name, np.shape(kw["terms"])))
            return _search(*a, **kw)
        retr.search = recording
    searches = s.metrics.histogram("search_ms/batched")
    n0 = searches.n
    # same groups at every other fill level and k mix: one search each
    for i, k in enumerate((5, 8, 10, 42, 100)):
        s.submit(_req(corpus, i, SHORT if i % 2 else LONG, k=k))
        s.flush()   # fill levels 1, 1, 1, ... (padded to max_batch)
    for i in range(3):
        s.submit(_req(corpus, i, SHORT, k=9))
    s.flush()       # fill level 3
    assert searches.n == n0 + 6
    assert s._retrievers == opened and all(
        s._retrievers[n] is r for n, r in opened.items())
    assert set(shapes) == {("short", (4, SHORT)), ("long", (4, LONG))}


def test_multi_row_request_is_atomic(setup):
    """A [3, Nq] request with per-row k rides one batch and slices back
    per-row; stats rows match the request's rows."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=8, cache_size=0))
    ks = [5, 10, 7]
    h = s.submit(SearchRequest(terms=corpus.queries[:3],
                               weights_b=corpus.q_weights_b[:3],
                               weights_l=corpus.q_weights_l[:3], k=ks))
    s.flush()
    resp = h.result()
    ref = open_retriever(index, RANK_SAFE).search(
        terms=corpus.queries[:3], weights_b=corpus.q_weights_b[:3],
        weights_l=corpus.q_weights_l[:3], k=ks)
    np.testing.assert_array_equal(resp.ids, ref.ids)
    np.testing.assert_array_equal(resp.scores, ref.scores)
    np.testing.assert_array_equal(resp.ks, ks)
    assert resp.stats["tiles_visited"].shape == (3,)


def test_threshold_factor_override_is_grouped_and_honored(setup):
    # pad_terms matches the query width: zero-width padding is a no-op
    # only above threshold, and factor=1.5 over-prunes past that
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, pad_terms=LONG, cache_size=0))
    h = s.submit(_req(corpus, 0, threshold_factor=1.5))
    s.flush()
    ref = open_retriever(index, RANK_SAFE).search(
        terms=corpus.queries[:1], weights_b=corpus.q_weights_b[:1],
        weights_l=corpus.q_weights_l[:1], k=10, threshold_factor=1.5)
    np.testing.assert_array_equal(h.result().ids, ref.ids)
    np.testing.assert_array_equal(h.result().scores, ref.scores)


# -- routing ------------------------------------------------------------------

def test_routing_policy_validation():
    with pytest.raises(ValueError, match="catch-all"):
        RoutingPolicy((route("a", 4),))
    with pytest.raises(ValueError, match="catch-all"):
        RoutingPolicy((route("a"), route("b", 4), route("c")))
    with pytest.raises(ValueError, match="ascend"):
        RoutingPolicy((route("a", 8), route("b", 4), route("c")))
    with pytest.raises(ValueError, match="duplicate"):
        RoutingPolicy((route("a", 4), route("a")))
    with pytest.raises(ValueError, match="at least one"):
        RoutingPolicy(())


def test_table8_policy_classification():
    p = table8_policy(short_max_len=4)
    assert p.classify(0).name == "short"
    assert p.classify(4).name == "short"
    assert p.classify(5).name == "long"
    assert p.by_name("short").pad_terms == 4
    with pytest.raises(KeyError, match="nope"):
        p.by_name("nope")


def test_query_length_counts_live_terms_only():
    assert query_length([1.0, 0.0, 2.0], [0.0, 0.0, 1.0]) == 2
    assert query_length([0.0, 0.0], [0.0, 0.0]) == 0


def test_policy_fingerprint_tracks_routes_and_params():
    a = table8_policy().fingerprint(twolevel.fast())
    assert a == table8_policy().fingerprint(twolevel.fast())
    assert a != table8_policy().fingerprint(twolevel.gti())
    assert a != table8_policy(short_max_len=2).fingerprint(twolevel.fast())
    assert a != single_route().fingerprint(twolevel.fast())


def test_scheduler_routes_by_live_length_and_reports_stats(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE, SchedulerConfig(max_batch=4, cache_size=0),
        routing=_two_class_policy("batched"))
    s.submit(_req(corpus, 0, SHORT))
    s.submit(_req(corpus, 1, LONG))
    # zero-weight padding does not change the class: a LONG-length query
    # whose tail weights are zero classifies as short
    wb, wl = corpus.q_weights_b[2].copy(), corpus.q_weights_l[2].copy()
    wb[SHORT:] = 0.0
    wl[SHORT:] = 0.0
    h = s.submit(SearchRequest(terms=corpus.queries[2], weights_b=wb,
                               weights_l=wl, k=10))
    s.flush()
    assert h.route == "short"
    st = s.stats()
    assert st["requests_by_route"] == {"short": 2, "long": 1}
    assert st["batches"] == 2 and st["completed"] == 3
    assert set(st["batches_by_group"]) == {"k10/short", "k10/long"}


# -- response cache -----------------------------------------------------------

def test_cache_hit_completes_at_submit(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=8))
    h1 = s.submit(_req(corpus, 0))
    s.flush()
    h2 = s.submit(_req(corpus, 0))
    assert h2.done() and h2.cached          # zero-service-time path
    assert h2.result().latency_ms == 0.0
    assert h2.latency_ms >= 0
    np.testing.assert_array_equal(h2.result().ids, h1.result().ids)
    np.testing.assert_array_equal(h2.result().scores, h1.result().scores)
    st = s.stats()
    assert st["cache_hits"] == 1 and st["cache_misses"] == 1
    assert st["completed"] == 2 and st["batches"] == 1


def test_cache_respects_depth_and_evicts_lru(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=2))
    s.submit(_req(corpus, 0))
    s.flush()
    # same query, different k in the same bucket: a different cache key,
    # served fresh — and both depths then coexist as entries
    h = s.submit(_req(corpus, 0, k=7))
    assert not h.done()
    s.flush()
    assert s.submit(_req(corpus, 0, k=7)).cached
    assert s.submit(_req(corpus, 0, k=10)).cached
    # two newer fingerprints evict both query-0 depths from a 2-entry cache
    s.submit(_req(corpus, 1))
    s.submit(_req(corpus, 2))
    s.flush()
    h2 = s.submit(_req(corpus, 0, k=7))
    assert not h2.done()
    s.flush()
    assert s.stats()["cache_entries"] == 2
    s.cache_clear()
    assert s.stats()["cache_entries"] == 0


def test_cache_key_includes_threshold_factor(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=8))
    s.submit(_req(corpus, 0))
    s.flush()
    h = s.submit(_req(corpus, 0, threshold_factor=1.5))
    assert not h.done()                      # different policy knob: miss
    s.flush()
    assert s.stats()["cache_hits"] == 0


# -- priorities ---------------------------------------------------------------

def test_priority_orders_dispatch_within_group(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=0))
    hs = {p: s.submit(_req(corpus, p), priority=p) for p in (2, 0, 3, 1)}
    s.flush()
    # batches of two: priorities {0, 1} dispatch before {2, 3}
    assert hs[0].t_done == hs[1].t_done
    assert hs[2].t_done == hs[3].t_done
    assert hs[1].t_done < hs[2].t_done


# -- threaded mode ------------------------------------------------------------

def test_threaded_mode_serves_without_explicit_poll(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, max_wait_ms=1.0, cache_size=0))
    with s:
        assert s.is_running()
        h = s.submit(_req(corpus, 0))
        resp = h.result(timeout=120.0)
    assert not s.is_running()
    assert resp.ids.shape == (1, 10)
    ref = open_retriever(index, RANK_SAFE).search(
        terms=corpus.queries[:1], weights_b=corpus.q_weights_b[:1],
        weights_l=corpus.q_weights_l[:1], k=10)
    np.testing.assert_array_equal(resp.ids, ref.ids)


def test_result_timeout_raises(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE)
    s.start()    # worker running -> result() will not self-flush
    try:
        # a request that cannot be admitted: worker waits on max_wait,
        # so an immediate tiny timeout fires first
        h = s.submit(_req(corpus, 0), now=1e12)   # deadline far future
        with pytest.raises(TimeoutError, match="not served"):
            h.result(timeout=0.01)
    finally:
        s.close()


# -- run_workload -------------------------------------------------------------

def test_run_workload_zero_service_cache_path(setup):
    """A workload served mostly from the cache keeps finite, clamped
    latency accounting (the zero-service-time path)."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=32))
    for i in range(4):   # warm the cache with the distinct queries
        s.submit(_req(corpus, i))
    s.flush()
    stats = run_workload(s, [_req(corpus, i % 4) for i in range(16)],
                         qps=500.0)
    assert stats["n"] == 16
    assert stats["cache_hits"] == 16
    assert np.isfinite(stats["mrt_ms"]) and stats["mrt_ms"] >= 0.0
    assert stats["p99_ms"] >= stats["p50_ms"] >= 0.0


def test_run_workload_survives_partial_route_failure(setup):
    """One broken route fails its own requests (handles resolve with the
    error, counted in stats) while the rest of the stream is still
    served and measured."""
    corpus, index = setup
    policy = RoutingPolicy((
        route("short", SHORT, "batched", bogus_opt=1),   # breaks at open
        route("long", None, "batched")))
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0),
                  routing=policy)
    reqs = [SearchRequest(terms=corpus.queries[i, :(SHORT, LONG)[i % 2]],
                          weights_b=corpus.q_weights_b[i, :(SHORT, LONG)[i % 2]],
                          weights_l=corpus.q_weights_l[i, :(SHORT, LONG)[i % 2]],
                          k=10)
            for i in range(8)]
    stats = run_workload(s, reqs, qps=5000.0)
    assert stats["failed"] == 4 and stats["completed"] == 4
    assert stats["n"] == 4                     # only served requests
    assert np.isfinite(stats["mrt_ms"])
    # a healthy handle's result() self-flush must not surface the broken
    # route's error: submit one of each, resolve the healthy one first
    h_bad = s.submit(reqs[0])                  # short -> broken route
    h_ok = s.submit(reqs[1])                   # long  -> healthy route
    resp = h_ok.result()                       # flushes both groups
    assert resp.ids.shape == (1, 10)
    with pytest.raises(TypeError, match="bogus_opt"):
        h_bad.result()


def test_run_workload_empty(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE)
    stats = run_workload(s, [], qps=100.0)
    assert stats["n"] == 0 and math.isnan(stats["mrt_ms"])
    assert stats["qps_achieved"] == 0.0


# -- the deprecated server shim -----------------------------------------------

def test_retrieval_server_warns_and_matches_retriever(setup):
    corpus, index = setup
    with pytest.warns(DeprecationWarning, match="AsyncRetrievalScheduler"):
        srv = Server(index, twolevel.fast(), ServerConfig(max_batch=4))
    for i in range(4):
        srv.submit(Request(corpus.queries[i], corpus.q_weights_b[i],
                           corpus.q_weights_l[i]), now=float(i))
    srv._flush()
    ref = open_retriever(index, twolevel.fast()).search(
        terms=corpus.queries[:4], weights_b=corpus.q_weights_b[:4],
        weights_l=corpus.q_weights_l[:4], k=10)
    got_ids = np.stack([r.ids for r in srv.completed])
    got_scores = np.stack([r.scores for r in srv.completed])
    np.testing.assert_array_equal(got_ids, ref.ids)
    np.testing.assert_array_equal(got_scores, ref.scores)
    assert all(r.t_done > 0 for r in srv.completed)


def test_request_latency_nan_while_in_flight():
    r = Request(np.array([1], np.int32), np.ones(1, np.float32),
                np.ones(1, np.float32))
    assert math.isnan(r.latency_ms)          # t_done unset: no garbage
    r.t_enqueue = 5.0
    assert math.isnan(r.latency_ms)
    r.t_done = 5.5
    assert r.latency_ms == pytest.approx(500.0)


# -- _pad_queries fast path ---------------------------------------------------

def test_pad_queries_rectangular_passthrough():
    from repro_torch.retrieval.retriever import _pad_queries
    t = np.arange(6, dtype=np.int32).reshape(2, 3)
    wb = np.ones((2, 3), np.float32)
    wl = np.ones((2, 3), np.float32)
    ot, ob, ol = _pad_queries(t, wb, wl)
    assert ot is t and ob is wb and ol is wl     # no copy, no loop


def test_pad_queries_device_arrays_stay_on_device():
    """The reference's jax device arrays are the port's tensors: a
    rectangular batch of the right dtypes keeps its objects (and so its
    device); a tensor of another dtype is cast where it lies."""
    from repro_torch.retrieval.retriever import _pad_queries
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    wb = torch.ones((2, 3), dtype=torch.float32)
    wl = torch.ones((2, 3), dtype=torch.float32)
    ot, ob, ol = _pad_queries(t, wb, wl)
    assert ot is t and ob is wb and ol is wl     # no host round-trip
    ot, _, _ = _pad_queries(t.long(), wb, wl)
    assert ot.dtype == torch.int32 and ot.device == t.device


def test_cuda_without_a_gpu_raises(setup):
    """The entry points serve from ``"cuda"`` by default; without a GPU
    they raise at construction instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, index = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncRetrievalScheduler(index, RANK_SAFE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncRetrievalScheduler(index, RANK_SAFE, device="cuda:0")
    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalServer(index, RANK_SAFE)


def test_tensor_requests_are_read_to_the_host_once(setup):
    """Request fields may be tensors (the reference takes jax device
    arrays): rows, cache keys and results equal those of the same request
    in numpy, and a [B, Nq] tensor request rides one batch."""
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, pad_terms=LONG, cache_size=8))
    h_np = s.submit(_req(corpus, 0, qlen=SHORT))
    s.flush()
    t = {f: torch.from_numpy(getattr(corpus, a)[0, :SHORT].copy())
         for f, a in (("terms", "queries"), ("weights_b", "q_weights_b"),
                      ("weights_l", "q_weights_l"))}
    h_t = s.submit(SearchRequest(**t, k=10))
    assert h_t.cached                        # same fingerprint as numpy
    np.testing.assert_array_equal(h_t.result().ids, h_np.result().ids)
    rows = SearchRequest(terms=torch.from_numpy(corpus.queries[:2]),
                         weights_b=torch.from_numpy(corpus.q_weights_b[:2]),
                         weights_l=torch.from_numpy(corpus.q_weights_l[:2]),
                         k=10)
    h_rows = s.submit(rows)
    s.flush()
    ref = open_retriever(index, RANK_SAFE).search(
        terms=corpus.queries[:2], weights_b=corpus.q_weights_b[:2],
        weights_l=corpus.q_weights_l[:2], k=10)
    np.testing.assert_array_equal(h_rows.result().ids, ref.ids)
    assert isinstance(h_rows.result().ids, np.ndarray)
