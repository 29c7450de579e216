"""The port's executor pool + backpressure (``repro_torch.serve``), on
the CPU: the ``tests/test_executor.py`` suite on the port (same names,
same assertions), every scheduler and retriever on ``device="cpu"``.

Replica cloning, N-executor parity (the acceptance contract:
bit-identical to single-executor, cache hits included), the warmup grid,
drain-on-close, snapshot-consistent stats under concurrent workers,
bounded admission (block/reject/shed), and the priority-aging starvation
bound. Added: the scheduler, its routes and every pool replica share one
copy of the index, before and after a hot swap, and the sharded routes
one partition of it per generation. The port compiles nothing, so
the warmup-grid test counts searches instead of jit cache entries (its
docstring says how).

The saturation soaks run under the ``stress`` marker, as the
reference's do.
"""
import functools
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.retrieval import Retriever, SearchRequest
from repro_torch.serve import (AsyncRetrievalScheduler, ExecutorPool,
                               RoutingPolicy, SchedulerConfig,
                               SchedulerSaturated, mixed_request_stream,
                               route, run_workload, warmup_grid)

RANK_SAFE = twolevel.original(gamma=0.2)
SHORT, LONG = 3, 5   # live-term counts in the small_corpus stream

# the suites run on the CPU; the entry points default to "cuda"
Scheduler = functools.partial(AsyncRetrievalScheduler, device="cpu")
open_retriever = functools.partial(Retriever.open, device="cpu")


def _small_corpus():
    # conftest's small_corpus, built by the port
    return make_corpus("splade_like", n_docs=2048, n_terms=512,
                       n_queries=12, n_q_terms=5, n_rel=3,
                       avg_doc_terms=24, seed=7)


@pytest.fixture(scope="module")
def setup():
    corpus = _small_corpus()
    index = build_index(corpus.merged("scaled"), tile_size=256,
                        device="cpu")
    return corpus, index


def _req(corpus, i, qlen=None, k=10):
    q, wb, wl = (corpus.queries[i], corpus.q_weights_b[i],
                 corpus.q_weights_l[i])
    if qlen is not None:
        q, wb, wl = q[:qlen], wb[:qlen], wl[:qlen]
    return SearchRequest(terms=q, weights_b=wb, weights_l=wl, k=k)


def _two_class_policy(engine="batched", **opts):
    return RoutingPolicy((
        route("short", SHORT, engine, pad_terms=SHORT, **opts),
        route("long", None, engine, **opts)))


def _sched(index, executors=0, cache=0, routing=None, **cfg):
    return Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, max_wait_ms=5.0, cache_size=cache,
                        executors=executors, **cfg),
        routing=routing if routing is not None else _two_class_policy(),
        k_buckets=(10, 100))


def _stream(corpus, n):
    return mixed_request_stream(corpus, n, short_len=SHORT,
                                k_pool=(10, 100), query_pool=6)


def _invariant(st):
    return st["submitted"] == (st["completed"] + st["failed"] + st["shed"]
                               + st["rejected"] + st["pending"]
                               + st["in_flight"])


# -- replica cloning ----------------------------------------------------------

@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("kernel", {}), ("sequential", {"warmup": False}),
    ("sharded", {"n_shards": 2})])
def test_replicate_shares_index_and_matches(setup, engine, opts):
    corpus, index = setup
    base = open_retriever(index, RANK_SAFE, engine=engine, **opts)
    rep = base.replicate()
    assert rep is not base and rep.engine is not base.engine
    assert rep.engine.index is base.engine.index
    assert rep.engine_name == base.engine_name
    assert rep.k_buckets == base.k_buckets
    q = corpus.queries[:2]
    a = base.search(terms=q, weights_b=corpus.q_weights_b[:2],
                    weights_l=corpus.q_weights_l[:2], k=10)
    b = rep.search(terms=q, weights_b=corpus.q_weights_b[:2],
                   weights_l=corpus.q_weights_l[:2], k=10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_replicate_shares_sharded_partition(setup):
    """A sharded replica must reuse the already-partitioned tile ranges
    (no re-partition at clone time)."""
    _, index = setup
    base = open_retriever(index, RANK_SAFE, engine="sharded", n_shards=2)
    rep = base.replicate()
    assert rep.engine.sharded is base.engine.sharded


def test_sharded_routes_share_one_partition_per_generation(setup):
    """Sharded routes open on one partition of the scheduler's index per
    (generation, shard count): both routes and every pool replica share
    it, the pool serves the stream as the synchronous scheduler does, and
    ``swap_index`` partitions the new index once."""
    from repro_torch.core import shard_plan
    corpus, index = setup
    calls = []
    real = shard_plan.shard_index

    def counting(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)
    shard_plan.shard_index = counting
    try:
        policy = RoutingPolicy((
            route("short", SHORT, "sharded", pad_terms=SHORT, n_shards=2),
            route("long", None, "sharded", n_shards=2,
                  traversal="chunked")))
        cfg = dict(max_batch=4, pad_terms=LONG, cache_size=0)
        sync = Scheduler(index, RANK_SAFE, SchedulerConfig(**cfg),
                         routing=policy)
        stream = _stream(corpus, 16)
        want = [sync.submit(r) for r in stream]
        sync.flush()
        s = Scheduler(index, RANK_SAFE,
                      SchedulerConfig(**cfg, executors=2), routing=policy)
        n_sync = len(calls)
        with s:
            got = [s.submit(r).result(timeout=60) for r in stream]
            masters = [s._retriever(r.name) for r in policy.all_routes]
            replicas = [rep for m in s._pool.replicas.values()
                        for rep in m.values()]
            part = masters[0].engine.sharded
            assert all(r.engine.sharded is part
                       for r in masters + replicas)
            assert len(calls) == n_sync + 1
            s.swap_index(build_index(corpus.merged("scaled"),
                                     tile_size=256, device="cpu"),
                         warm=False)
            assert len(calls) == n_sync + 2
            fresh = s._retriever("long").engine.sharded
            assert fresh is not part
            assert s._retriever("short").engine.sharded is fresh
        assert calls == [2] * len(calls) and n_sync == 1
        for h, a in zip(want, got):
            np.testing.assert_array_equal(h.result().ids, a.ids)
            np.testing.assert_array_equal(h.result().scores, a.scores)
    finally:
        shard_plan.shard_index = real


def test_scheduler_and_pool_share_one_index(setup):
    """The scheduler moves the index to its device once and opens every
    route on that copy; every pool replica shares it. After a hot swap
    the same holds for the new index (a host index is never copied per
    route, per replica or per generation)."""
    corpus, index = setup
    s = _sched(index)
    assert s.index is index                  # already on the device
    pool = ExecutorPool(s, 2)
    pool.start()
    try:
        masters = [s._retriever(r.name) for r in s.routing.all_routes]
        replicas = [rep for m in pool.replicas.values() for rep in m.values()]
        assert len(masters) == 2 and len(replicas) == 4
        assert all(r.engine.index is index for r in masters + replicas)
        assert all(m.stream is None for m in pool.replicas.values())
        fresh = build_index(corpus.merged("scaled"), tile_size=256,
                            device="cpu")
        s.swap_index(fresh, warm=False)
        assert s.index is fresh
        assert all(s._retriever(r.name).engine.index is fresh
                   for r in s.routing.all_routes)
        for slot in pool.replicas:
            for name in ("short", "long"):
                retr, gen = s._resolve_retriever(name, pool.replicas[slot])
                assert gen == 1 and retr.engine.index is fresh
    finally:
        pool.close()


def test_replicate_requires_engine_support(setup):
    _, index = setup
    r = open_retriever(index, RANK_SAFE)

    class NoReplica:
        name = "stub"
    r.engine = NoReplica()
    with pytest.raises(TypeError, match="replicate"):
        r.replicate()


# -- N-executor parity (the acceptance contract) ------------------------------

def test_pool_parity_bit_identical_with_cache_hits(setup):
    """A mixed-k, mixed-length stream — submitted twice, so the second
    pass is served from the response cache — returns bit-identical
    ids/scores through a 3-executor pool and through the sync
    single-dispatch path."""
    corpus, index = setup
    reqs = _stream(corpus, 16)

    def serve(executors):
        s = _sched(index, executors=executors, cache=64)
        if executors:
            with s:
                first = [h.result(timeout=60)
                         for h in [s.submit(r) for r in reqs]]
                second = [h.result(timeout=60)
                          for h in [s.submit(r) for r in reqs]]
        else:
            hs = [s.submit(r) for r in reqs]
            s.flush()
            first = [h.result() for h in hs]
            hs = [s.submit(r) for r in reqs]
            s.flush()
            second = [h.result() for h in hs]
        return first, second, s.stats()

    f0, s0, st0 = serve(0)
    f3, s3, st3 = serve(3)
    for a, b in zip(f0 + s0, f3 + s3):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.ks, b.ks)
    # the replay pass hits the cache in both modes
    assert st0["cache_hits"] >= len(reqs)
    assert st3["cache_hits"] >= len(reqs)
    assert _invariant(st0) and _invariant(st3)


def test_pool_executors_share_the_work(setup):
    """Under a submit-then-drain burst every executor should pull
    batches; per-executor counters aggregate to the batch total."""
    corpus, index = setup
    s = _sched(index, executors=2)
    with s:
        hs = [s.submit(r) for r in _stream(corpus, 24)]
        for h in hs:
            h.result(timeout=60)
    st = s.stats()
    assert sum(st["batches_by_executor"].values()) == st["batches"]
    assert sum(st["rows_by_executor"].values()) == st["rows_executed"]
    assert len(st["batches_by_executor"]) >= 1
    assert _invariant(st)


# -- warmup grid / compile discipline ----------------------------------------

def test_warmup_compiles_exactly_the_routing_grid():
    """``warmup()`` runs exactly one search per (route x k-bucket) cell
    of the grid, and serving any request shape afterwards opens no new
    Retriever. The JAX package pins this as jit cache entries (one per
    cell, none later); the port compiles nothing (no ``torch.compile``,
    no CUDA graphs), so the cells are counted as searches — the
    scheduler registry's ``search_ms/<engine>`` histogram — and "no
    retrace" as the set of open Retrievers staying the same objects."""
    small_corpus = _small_corpus()
    index = build_index(small_corpus.merged("scaled"), tile_size=16,
                        device="cpu")
    s = _sched(index)
    grid = warmup_grid(s.routing, s.k_buckets, s.cfg.pad_terms)
    assert len(grid) == 4   # 2 routes x 2 buckets
    searches = s.metrics.histogram("search_ms/batched")
    assert searches.n == 0
    s.warmup()
    assert searches.n == len(grid)
    opened = dict(s._retrievers)
    assert set(opened) == {"short", "long"}
    assert s.stats()["warmup_s"] > 0
    for i, k in enumerate((5, 10, 42, 100)):
        s.submit(_req(small_corpus, i, SHORT if i % 2 else LONG, k=k))
    s.flush()
    assert searches.n == len(grid) + s.stats()["batches"]
    assert all(s._retrievers[n] is r for n, r in opened.items())
    assert len(s._retrievers) == len(opened)


def test_pool_start_builds_replicas_and_warms(setup):
    corpus, index = setup
    s = _sched(index)
    pool = ExecutorPool(s, 2)
    pool.start()
    try:
        assert pool.is_running()
        assert set(pool.replicas) == {0, 1}
        for slot in (0, 1):
            assert set(pool.replicas[slot]) == {"short", "long"}
            for name, rep in pool.replicas[slot].items():
                assert rep is not s._retrievers[name]
        assert s.stats()["warmup_s"] > 0
    finally:
        pool.close()
    assert not pool.is_running()


# -- drain-on-close -----------------------------------------------------------

def test_pool_drains_backlog_on_close(setup):
    """close() lets the executors empty the group queues: every handle
    resolves even for requests whose deadline is far in the future."""
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, max_wait_ms=60_000.0, cache_size=0,
                        executors=2),
        routing=_two_class_policy(), k_buckets=(10, 100))
    s.start()
    hs = [s.submit(r) for r in _stream(corpus, 10)]
    s.close()
    assert all(h.done() for h in hs)
    st = s.stats()
    assert st["pending"] == 0 and st["in_flight"] == 0
    assert st["completed"] == len(hs)
    assert _invariant(st)


# -- stats consistency under concurrent workers -------------------------------

def test_stats_snapshots_consistent_under_pool(setup):
    """Every stats() snapshot taken while 2 executors race must satisfy
    the counter invariant — the whole dict is read under one lock
    acquisition, never a torn mix of before/after states.

    The port's executors give up the interpreter lock at every torch op
    and must win it back (the reference's make one jit call per batch):
    at the default 5 ms switch interval this spinning reader makes each
    op wait up to 5 ms, and the stream takes minutes. So the reader runs
    at a 10 us switch interval, which interleaves it with the executors
    more finely, not less."""
    corpus, index = setup
    s = _sched(index, executors=2, cache=16)
    reqs = _stream(corpus, 32)
    snapshots = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with s:
            hs = [s.submit(r) for r in reqs]
            while not all(h.done() for h in hs):
                snapshots.append(s.stats())
    finally:
        sys.setswitchinterval(interval)
    snapshots.append(s.stats())
    assert all(_invariant(st) for st in snapshots)
    final = snapshots[-1]
    assert final["completed"] == len(reqs)
    assert final["admitted"] == final["submitted"] - final["rejected"]


def test_stats_returns_detached_dicts(setup):
    corpus, index = setup
    s = _sched(index)
    s.submit(_req(corpus, 0))
    st = s.stats()
    st["requests_by_route"]["long"] = 999
    st["batches_by_executor"][7] = 1
    assert s.stats()["requests_by_route"] != st["requests_by_route"]
    assert 7 not in s.stats()["batches_by_executor"]


# -- bounded admission --------------------------------------------------------

def test_admission_reject_raises_and_counts(setup):
    corpus, index = setup
    s = _sched(index, admission_limit=2, admission_policy="reject")
    s.submit(_req(corpus, 0), now=0.0)
    s.submit(_req(corpus, 1), now=0.0)
    with pytest.raises(SchedulerSaturated, match="rejected"):
        s.submit(_req(corpus, 2), now=0.0)
    st = s.stats()
    assert st["rejected"] == 1 and st["admitted"] == 2
    assert _invariant(st)
    s.flush()
    assert s.stats()["completed"] == 2


def test_admission_shed_drops_least_important(setup):
    """An important submission sheds the least-important queued request
    (its handle fails with SchedulerSaturated); an unimportant one is
    refused instead."""
    corpus, index = setup
    s = _sched(index, admission_limit=2, admission_policy="shed")
    h_low = s.submit(_req(corpus, 0), priority=5, now=0.0)
    h_mid = s.submit(_req(corpus, 1), priority=1, now=0.0)
    h_hi = s.submit(_req(corpus, 2), priority=0, now=0.0)   # sheds h_low
    with pytest.raises(SchedulerSaturated):
        h_low.result(timeout=0.1)
    with pytest.raises(SchedulerSaturated, match="shed at admission"):
        s.submit(_req(corpus, 3), priority=9, now=0.0)      # refused
    s.flush()
    assert h_mid.result().ids is not None
    assert h_hi.result().ids is not None
    st = s.stats()
    assert st["shed"] == 1 and st["rejected"] == 1
    assert st["completed"] == 2 and _invariant(st)


def test_admission_block_inline_drains_in_sync_mode(setup):
    """With no worker running, a blocked submit must dispatch the queue
    itself instead of deadlocking the only thread."""
    corpus, index = setup
    s = _sched(index, admission_limit=2, admission_policy="block")
    hs = [s.submit(r) for r in _stream(corpus, 8)]
    s.flush()
    assert all(h.done() for h in hs)
    assert s.stats()["completed"] == 8


def test_admission_block_waits_for_pool(setup):
    corpus, index = setup
    s = _sched(index, executors=2, admission_limit=4,
               admission_policy="block")
    with s:
        hs = [s.submit(r) for r in _stream(corpus, 12)]
        for h in hs:
            h.result(timeout=60)
    st = s.stats()
    assert st["completed"] == 12 and st["rejected"] == 0
    assert _invariant(st)


def test_admission_guards(setup):
    corpus, index = setup
    with pytest.raises(ValueError, match="admission_policy"):
        Scheduler(index, RANK_SAFE, SchedulerConfig(admission_policy="nope"))
    with pytest.raises(ValueError, match="executors"):
        Scheduler(index, RANK_SAFE, SchedulerConfig(executors=-1))
    with pytest.raises(ValueError, match="never be admitted"):
        s = _sched(index, admission_limit=2)
        s.submit(SearchRequest(terms=corpus.queries[:3],
                               weights_b=corpus.q_weights_b[:3],
                               weights_l=corpus.q_weights_l[:3], k=10))
    with pytest.raises(ValueError, match=">= 1 executors"):
        ExecutorPool(_sched(index), 0)


# -- priority aging: the starvation bound -------------------------------------

def _aging_rounds(s, corpus, h_low, rounds, dt=0.05):
    """Saturating high-priority stream on a simulated clock: each round
    submits a full batch of fresh priority-0 requests at t, then picks
    and executes exactly one batch. Returns the round index at which the
    low-priority handle completed (or ``rounds`` if starved)."""
    for r in range(rounds):
        t = (r + 1) * dt
        for j in range(4):
            s.submit(_req(corpus, (r * 4 + j) % 8, LONG, k=10),
                     priority=0, now=t)
        picked = s._pick_batch(t, False)
        assert picked is not None
        s._execute(*picked)
        if h_low.done():
            return r
    return rounds


def test_aging_bounds_starvation(setup):
    """With ``aging_ms=25`` a priority-5 request admitted at t=0 gains a
    level every 25 ms; by t=125ms it outranks fresh priority-0 traffic
    and must ride the next batch — within 3 rounds of 50 ms here. The
    strict-priority control (aging off) starves it for the whole run."""
    corpus, index = setup

    def build(aging_ms):
        s = Scheduler(
            index, RANK_SAFE,
            SchedulerConfig(max_batch=4, max_wait_ms=0.0, cache_size=0,
                            aging_ms=aging_ms),
            routing=_two_class_policy(), k_buckets=(10, 100))
        h_low = s.submit(_req(corpus, 11, LONG, k=10), priority=5, now=0.0)
        return s, h_low

    s, h_low = build(aging_ms=25.0)
    done_at = _aging_rounds(s, corpus, h_low, rounds=10)
    assert done_at <= 3, f"low-priority request starved {done_at} rounds"

    s, h_low = build(aging_ms=0.0)   # strict priority: starves
    done_at = _aging_rounds(s, corpus, h_low, rounds=10)
    assert done_at == 10 and not h_low.done()


# -- threaded workload driver -------------------------------------------------

def test_run_workload_threaded_over_pool(setup):
    corpus, index = setup
    s = _sched(index, executors=2, cache=16)
    with s:
        res = run_workload(s, _stream(corpus, 16), qps=400.0)
    assert res["n"] == 16 and res["completed"] == 16
    assert res["qps_achieved"] > 0 and np.isfinite(res["mrt_ms"])


# -- saturation soaks (the slow, threaded lane) -------------------------------

@pytest.mark.stress
def test_stress_pool_saturation_with_shedding(setup):
    """4 executors, a bounded shedding queue, and an offered load far
    above capacity: everything submitted either completes or is
    accounted shed/rejected, every snapshot satisfies the invariant,
    and the queue never exceeds its bound."""
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, max_wait_ms=2.0, cache_size=0,
                        executors=4, admission_limit=8,
                        admission_policy="shed", aging_ms=20.0),
        routing=_two_class_policy(), k_buckets=(10, 100))
    reqs = _stream(corpus, 96)
    bounds_ok = True
    with s:
        hs = []
        for i, r in enumerate(reqs):
            try:
                hs.append(s.submit(r, priority=i % 3))
            except SchedulerSaturated:
                pass
            st = s.stats()
            bounds_ok &= st["pending_rows"] <= 8 and _invariant(st)
        for h in hs:
            try:
                h.result(timeout=120)
            except SchedulerSaturated:
                pass
    st = s.stats()
    assert bounds_ok
    assert _invariant(st)
    assert st["pending"] == 0 and st["in_flight"] == 0
    assert st["completed"] + st["shed"] + st["rejected"] == st["submitted"]
    assert st["completed"] > 0


@pytest.mark.stress
def test_stress_concurrent_submitters(setup):
    """4 submitter threads x 2 executors racing on one scheduler: all
    requests complete, results match the sync path bit-for-bit."""
    corpus, index = setup
    reqs = _stream(corpus, 12)
    ref = _sched(index)
    ref_out = []
    for r in reqs:
        h = ref.submit(r)
        ref.flush()
        ref_out.append(h.result())

    s = _sched(index, executors=2)
    results = [None] * (4 * len(reqs))
    errors = []

    def submitter(tid):
        try:
            hs = [(i, s.submit(r)) for i, r in enumerate(reqs)]
            for i, h in hs:
                results[tid * len(reqs) + i] = h.result(timeout=120)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    with s:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors
    for tid in range(4):
        for i, expect in enumerate(ref_out):
            got = results[tid * len(reqs) + i]
            np.testing.assert_array_equal(got.ids, expect.ids)
            np.testing.assert_array_equal(got.scores, expect.scores)
    st = s.stats()
    assert st["completed"] == 4 * len(reqs) and _invariant(st)
