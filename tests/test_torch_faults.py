"""The port's fault tolerance (``repro_torch.serve``), on the CPU: the
``tests/test_faults.py`` suite on the port (same names, same
assertions), every scheduler on ``device="cpu"``.

Deadlines, retries + hedging, breakers + degraded mode, and
generation-safe hot swap — all pinned on a **simulated clock** (every
scheduler/health entry point takes an explicit ``now``), so none of
these tests sleeps to make a fault happen.

The soak test at the bottom is the integration pin: a mixed-k Poisson
stream with injected failures and a mid-stream ``swap_index`` must lose
zero handles, keep the accounting invariant in every snapshot, and
never deliver a cross-generation response.
"""
import functools
import threading

import numpy as np
import pytest

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.retrieval import SearchRequest
from repro_torch.serve import (BREAKER_CLOSED, BREAKER_DEAD,
                               BREAKER_HALF_OPEN, BREAKER_OPEN,
                               AsyncRetrievalScheduler, DeadlineExceeded,
                               Fault, FaultPlan, HealthConfig, HealthMonitor,
                               InjectedFault, ReplicaMap, RetryPolicy,
                               RoutingPolicy, SchedulerConfig, SearchTimeout,
                               delay_route, fail_batch, kill_executor,
                               poison_generation, route, run_workload)

RANK_SAFE = twolevel.original(gamma=0.2)
SHORT = 3

# the suites run on the CPU; the entry points default to "cuda"
Scheduler = functools.partial(AsyncRetrievalScheduler, device="cpu")


def _build(corpus):
    return build_index(corpus.merged("scaled"), tile_size=256,
                       device="cpu")


@pytest.fixture(scope="module")
def setup():
    # conftest's small_corpus, built by the port
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    return corpus, _build(corpus)


def _req(corpus, i, qlen=None, k=10, deadline_ms=None):
    q, wb, wl = (corpus.queries[i], corpus.q_weights_b[i],
                 corpus.q_weights_l[i])
    if qlen is not None:
        q, wb, wl = q[:qlen], wb[:qlen], wl[:qlen]
    return SearchRequest(terms=q, weights_b=wb, weights_l=wl, k=k,
                         deadline_ms=deadline_ms)


def _invariant(st) -> bool:
    return (st["submitted"] == st["completed"] + st["failed"] + st["shed"]
            + st["rejected"] + st["expired"] + st["pending"]
            + st["in_flight"])


def _drain(s, t, step=0.002, rounds=500):
    """Force-drain on the simulated clock, absorbing injected faults
    (each failing batch resolves its own handles)."""
    for _ in range(rounds):
        if not s.pending_count():
            return t
        picked = s._pick_batch(t, True)
        if picked is None:
            t += step
            continue
        try:
            s._execute(*picked, now=t)
        except InjectedFault:
            pass
        t += step
    raise AssertionError("drain did not terminate")


# -- deadlines ----------------------------------------------------------------

def test_deadline_sheds_expired_entry_at_pick(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    h = s.submit(_req(corpus, 0, deadline_ms=50.0), now=0.0)
    assert h.deadline_ms == 50.0
    # the budget ran out while queued: shed at pick time, never executed
    assert s._pick_batch(1.0, True) is None
    st = s.stats()
    assert st["expired"] == 1 and st["pending"] == 0
    assert st["batches"] == 0 and _invariant(st)
    with pytest.raises(DeadlineExceeded, match="expired before dispatch"):
        h.result()


def test_deadline_met_in_time_executes_normally(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    h = s.submit(_req(corpus, 0, deadline_ms=100.0), now=0.0)
    picked = s._pick_batch(0.02, True)
    assert picked is not None
    assert s._execute(*picked, now=0.02) == 1
    assert h.result().ids.shape == (1, 10)
    st = s.stats()
    assert st["expired"] == 0 and st["completed"] == 1 and _invariant(st)


def test_deadline_validation(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE)
    with pytest.raises(ValueError, match="deadline_ms"):
        s.submit(_req(corpus, 0, deadline_ms=0.0))
    with pytest.raises(TypeError, match="not both"):
        s.submit(_req(corpus, 0), deadline_ms=5.0)


def test_inflight_batch_carries_min_deadline_budget(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    s.submit(_req(corpus, 0, deadline_ms=100.0), now=0.0)
    s.submit(_req(corpus, 1, deadline_ms=40.0), now=0.0)
    key, batch = s._pick_batch(0.02, True)
    token = s._begin_batch(key, batch, None, now=0.02)
    # min remaining budget over the rows: 40ms deadline, 20ms elapsed
    assert s._inflight[token].budget_ms == pytest.approx(20.0)
    assert s._run_attempt(token, now=0.02) == 2


def test_run_workload_reports_goodput_next_to_qps(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    reqs = [_req(corpus, i % 4, deadline_ms=10_000.0) for i in range(6)]
    stats = run_workload(s, reqs, qps=1000.0)
    assert stats["n"] == stats["n_in_deadline"] == 6
    assert stats["goodput_qps"] > 0
    assert stats["goodput_qps"] <= stats["qps_achieved"] * 1.001


# -- retries ------------------------------------------------------------------

def test_retry_requeues_with_backoff_then_succeeds(setup):
    corpus, index = setup
    plan = FaultPlan([fail_batch(0)])
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0,
                        retry=RetryPolicy(max_attempts=3, backoff_ms=10.0,
                                          backoff_factor=2.0, jitter=0.0)),
        faults=plan)
    h = s.submit(_req(corpus, 0), now=0.0)
    picked = s._pick_batch(0.01, False)
    assert picked is not None
    # the injected failure requeues instead of raising or failing handles
    assert s._execute(*picked, now=0.01) == 0
    st = s.stats()
    assert st["retries"] == 1 and st["failed"] == 0 and _invariant(st)
    # backoff: invisible to pick before not_before (0.01 + 10ms)...
    assert s._pick_batch(0.015, False) is None
    assert s.next_deadline() == pytest.approx(0.02)
    # ...eligible again after it, and the retry succeeds (fault consumed)
    picked = s._pick_batch(0.021, False)
    assert picked is not None
    assert s._execute(*picked, now=0.021) == 1
    assert h.result().ids.shape == (1, 10)
    assert plan.fired == [("fail", None, 0, "all", 0)]


def test_retry_exhaustion_fails_handles_and_reraises(setup):
    corpus, index = setup
    plan = FaultPlan([Fault("fail", times=None)])   # every attempt fails
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0,
                        retry=RetryPolicy(max_attempts=2, backoff_ms=1.0,
                                          jitter=0.0)),
        faults=plan)
    h = s.submit(_req(corpus, 0), now=0.0)
    assert s._execute(*s._pick_batch(0.01, True), now=0.01) == 0
    with pytest.raises(InjectedFault):
        s._execute(*s._pick_batch(1.0, True), now=1.0)
    with pytest.raises(InjectedFault):
        h.result()
    st = s.stats()
    assert st["retries"] == 1 and st["failed"] == 1 and _invariant(st)


def test_non_retryable_fault_fails_fast(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0,
                        retry=RetryPolicy(max_attempts=5)),
        faults=FaultPlan([fail_batch(0, retryable=False)]))
    h = s.submit(_req(corpus, 0), now=0.0)
    with pytest.raises(InjectedFault):
        s._execute(*s._pick_batch(0.01, True), now=0.01)
    with pytest.raises(InjectedFault):
        h.result()
    st = s.stats()
    assert st["retries"] == 0 and st["failed"] == 1 and _invariant(st)


def test_retry_policy_backoff_is_deterministic():
    p = RetryPolicy(backoff_ms=100.0, backoff_factor=2.0, jitter=0.5,
                    seed=3)
    d = p.delay_ms(2, token=9)
    assert d == p.delay_ms(2, token=9)            # pure in (seed, token, a)
    assert 100.0 <= d <= 300.0                    # base 200 +- 50%
    assert p.delay_ms(2, token=10) != d
    assert p.delay_ms(3, token=9) != d
    exact = RetryPolicy(backoff_ms=10.0, backoff_factor=3.0, jitter=0.0)
    assert exact.delay_ms(1) == 10.0 and exact.delay_ms(3) == 90.0


def test_retry_policy_validation_and_retryable_predicate():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=1.5)
    with pytest.raises(ValueError, match="backoff"):
        RetryPolicy(backoff_factor=0.5)
    assert RetryPolicy.retryable(InjectedFault("x", retryable=True))
    assert not RetryPolicy.retryable(InjectedFault("x", retryable=False))
    assert RetryPolicy.retryable(TimeoutError())
    assert RetryPolicy.retryable(ConnectionResetError())
    assert not RetryPolicy.retryable(ValueError("deterministic"))


# -- breakers / health --------------------------------------------------------

def test_breaker_full_cycle_on_simulated_clock():
    hm = HealthMonitor(HealthConfig(failure_threshold=2, cooldown_ms=100.0))
    assert hm.state(0) == BREAKER_CLOSED and not hm.degraded()
    hm.record_failure(0, now=0.0)
    assert hm.state(0) == BREAKER_CLOSED          # below threshold
    hm.record_failure(0, now=0.01)
    assert hm.state(0) == BREAKER_OPEN and hm.degraded()
    assert not hm.allow(0, now=0.05)              # cooling down
    assert hm.allow(0, now=0.12)                  # half-open probe
    assert hm.state(0) == BREAKER_HALF_OPEN
    assert not hm.allow(0, now=0.13)              # one probe at a time
    hm.record_failure(0, now=0.14)                # probe failed: reopen
    assert hm.state(0) == BREAKER_OPEN
    assert not hm.allow(0, now=0.2)               # cooldown restarted
    assert hm.allow(0, now=0.25)                  # next probe
    hm.record_success(0, 5.0, now=0.26)           # probe won: close
    assert hm.state(0) == BREAKER_CLOSED and not hm.degraded()


def test_breaker_lost_probe_rearms_after_cooldown():
    hm = HealthMonitor(HealthConfig(failure_threshold=1, cooldown_ms=50.0))
    hm.record_failure(0, now=0.0)
    assert hm.allow(0, now=0.06)                  # probe taken...
    assert not hm.allow(0, now=0.07)              # ...and outstanding
    assert hm.allow(0, now=0.12)                  # lost probe self-heals


def test_dead_breaker_is_terminal():
    hm = HealthMonitor()
    hm.mark_dead(1)
    assert hm.state(1) == BREAKER_DEAD and hm.degraded()
    hm.record_success(1, 1.0, now=0.0)            # cannot resurrect
    assert not hm.allow(1, now=1e9)
    assert hm.snapshot()[1]["state"] == BREAKER_DEAD


def test_health_ewma_and_p99():
    hm = HealthMonitor(HealthConfig(ewma_decay=0.6))
    hm.record_success(0, 100.0, now=0.0)
    hm.record_success(0, 50.0, now=0.1)
    assert hm.snapshot()[0]["ewma_ms"] == pytest.approx(80.0)
    # exact-rank p99 over {100, 50}: the max sample, not interpolated
    assert hm.latency_p99_ms() == pytest.approx(100.0)
    assert HealthMonitor().latency_p99_ms(default=7.0) == 7.0


def test_degraded_pool_rewrites_route_to_fallback_lane(setup):
    corpus, index = setup
    policy = RoutingPolicy(
        (route("short", SHORT, pad_terms=SHORT, fallback="short_fast"),
         route("long", None)),
        fallback_routes=(route("short_fast", pad_terms=SHORT),))
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=2, cache_size=8,
                        health=HealthConfig(failure_threshold=2)),
        routing=policy)
    # trip executor 0's breaker: the pool is now degraded
    s.health.record_failure(0, now=0.0)
    s.health.record_failure(0, now=0.0)
    assert s.health.degraded()
    h = s.submit(_req(corpus, 0, qlen=SHORT), now=0.0)
    assert s._execute(*s._pick_batch(0.01, True), now=0.01) == 1
    resp = h.result()
    assert resp.degraded
    st = s.stats()
    assert st["degraded_batches"] == 1
    assert st["cache_entries"] == 0               # degraded: never cached
    # heal the breaker: same request now serves the primary lane + caches
    s.health.record_success(0, 1.0, now=0.02)
    assert not s.health.degraded()
    h2 = s.submit(_req(corpus, 0, qlen=SHORT), now=0.03)
    assert not h2.done()                          # no stale degraded hit
    s._execute(*s._pick_batch(0.04, True), now=0.04)
    assert not h2.result().degraded
    assert s.stats()["cache_entries"] == 1
    h3 = s.submit(_req(corpus, 0, qlen=SHORT), now=0.05)
    assert h3.done() and h3.cached


def test_router_fallback_validation():
    with pytest.raises(ValueError, match="unknown route"):
        RoutingPolicy((route("a", None, fallback="ghost"),))
    with pytest.raises(ValueError, match="chains"):
        RoutingPolicy((route("a", None, fallback="b"),),
                      fallback_routes=(route("b", fallback="c"),
                                       route("c")))
    with pytest.raises(ValueError, match="pad_terms"):
        RoutingPolicy((route("a", None, pad_terms=4, fallback="b"),),
                      fallback_routes=(route("b", pad_terms=8),))


# -- hedging ------------------------------------------------------------------

def test_hedge_first_result_wins_loser_cancelled_at_queue(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, hedge_ms=5.0))
    h = s.submit(_req(corpus, 0), now=0.0)
    key, batch = s._pick_batch(0.01, True)
    token = s._begin_batch(key, batch, 0, now=0.01)
    assert s.hedge_due(now=0.012) == []           # younger than hedge_ms
    assert s.hedge_due(now=0.02, exclude_executor=0) == []   # own batch
    assert s.hedge_due(now=0.02, exclude_executor=1) == [token]
    assert s.hedge_due(now=0.03) == []            # one hedge per batch
    assert s.stats()["hedges"] == 1
    # winner delivers; the loser's token is gone -> cancelled at queue
    assert s._run_attempt(token, now=0.04, executor_id=1) == 1
    assert h.result().ids.shape == (1, 10)
    assert s._run_attempt(token, now=0.05, executor_id=0) == 0
    st = s.stats()
    assert st["hedges_cancelled"] == 1 and st["completed"] == 1
    assert st["batches"] == 1 and _invariant(st)


def test_hedge_loser_finishing_after_winner_counts_wasted(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, hedge_ms=5.0))
    h = s.submit(_req(corpus, 0), now=0.0)
    key, batch = s._pick_batch(0.01, True)
    token = s._begin_batch(key, batch, 0, now=0.01)
    assert s.hedge_due(now=0.02, exclude_executor=1) == [token]
    assert s._run_attempt(token, now=0.03, executor_id=1) == 1
    # the loser executed to completion but the record is gone: its
    # delivery is discarded and counted as wasted work
    assert s._deliver(token, None, 1, 0, degraded=False,
                      executor_id=0, t_done=0.04) == 0
    st = s.stats()
    assert st["hedges_wasted"] == 1 and st["completed"] == 1
    assert h.done() and _invariant(st)


def test_hedge_failure_while_other_attempt_races(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, hedge_ms=5.0))
    h = s.submit(_req(corpus, 0), now=0.0)
    key, batch = s._pick_batch(0.01, True)
    token = s._begin_batch(key, batch, 0, now=0.01)
    assert s.hedge_due(now=0.02, exclude_executor=1) == [token]
    # one racer fails while the other is still running: absorbed
    assert s._attempt_failed(token, InjectedFault("x"), 0, now=0.03) == 0
    assert s.stats()["hedge_failures"] == 1
    assert token in s._inflight
    assert s._run_attempt(token, now=0.04, executor_id=1) == 1
    assert h.result().ids.shape == (1, 10)
    assert _invariant(s.stats())


def test_hedge_delay_derived_from_latency_p99(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, hedge_ms=0.0,
                        hedge_from_p99=True))
    s.submit(_req(corpus, 0), now=0.0)
    key, batch = s._pick_batch(0.01, True)
    token = s._begin_batch(key, batch, 0, now=0.01)
    assert s.hedge_due(now=10.0) == []            # no samples, default 0
    s.health.record_success(1, 50.0, now=0.01)    # p99 is now 50ms
    assert s.hedge_due(now=0.04) == []            # 30ms in flight < p99
    assert s.hedge_due(now=0.07) == [token]       # 60ms in flight > p99
    assert s._run_attempt(token, now=0.08) == 1


# -- hot swap / generations ---------------------------------------------------

def test_swap_index_bumps_generation_and_purges_stale_cache(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=8))
    h = s.submit(_req(corpus, 0), now=0.0)
    s._execute(*s._pick_batch(0.01, True), now=0.01)
    assert h.result().generation == 0
    assert s.stats()["cache_entries"] == 1
    gen = s.swap_index(
        _build(corpus), warm=False)
    assert gen == s.generation == 1
    st = s.stats()
    assert st["swaps"] == 1 and st["cache_gen_evictions"] == 1
    assert st["cache_entries"] == 0               # no stale hits possible
    h2 = s.submit(_req(corpus, 0), now=0.02)
    assert not h2.done()                          # the old entry is gone
    s._execute(*s._pick_batch(0.03, True), now=0.03)
    assert h2.result().generation == 1
    # the rebuilt index is identical content: results must agree
    np.testing.assert_array_equal(h.result().ids, h2.result().ids)


def test_stale_generation_response_is_delivered_but_never_cached(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=1, cache_size=8))
    h = s.submit(_req(corpus, 0), now=0.0)
    key, batch = s._pick_batch(0.01, True)
    token = s._begin_batch(key, batch, None, now=0.01)
    retr0 = s._retriever("all")                   # gen-0 master
    s.swap_index(_build(corpus),
                 warm=False)
    # the in-flight batch finishes on its pre-swap retriever: the caller
    # still gets an answer (stamped gen 0), but it must not be cached
    resp, n_real, n_pad = s._search_batch(retr0, batch, None)
    assert s._deliver(token, resp, n_real, n_pad, degraded=False,
                      executor_id=None, t_done=0.02) == 1
    assert h.result().generation == 0
    st = s.stats()
    assert st["generation"] == 1 and st["cache_entries"] == 0
    assert _invariant(st)


def test_replica_map_rebuilds_after_swap(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=2, cache_size=0))
    rm = ReplicaMap({"all": s._retriever("all").replicate()}, generation=0)
    retr, gen = s._resolve_retriever("all", rm)
    assert gen == 0 and retr is rm["all"]
    s.swap_index(_build(corpus),
                 warm=False)
    retr, gen = s._resolve_retriever("all", rm)
    assert gen == 1 and rm.generation == 1
    assert retr.generation == 1                   # rebuilt from new master


# -- cache lifecycle ----------------------------------------------------------

def test_cache_ttl_evicts_on_lookup(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=2, cache_size=8, cache_ttl_s=1.0))
    s.submit(_req(corpus, 0), now=0.0)
    s._execute(*s._pick_batch(0.01, True), now=0.0)
    h_fresh = s.submit(_req(corpus, 0), now=0.5)
    assert h_fresh.done() and h_fresh.cached      # within TTL
    h_stale = s.submit(_req(corpus, 0), now=2.0)
    assert not h_stale.done()                     # over-age: evicted
    st = s.stats()
    assert st["cache_ttl_evictions"] == 1 and st["cache_entries"] == 0
    s._execute(*s._pick_batch(2.1, True), now=2.1)
    assert h_stale.result().ids.shape == (1, 10)
    h_again = s.submit(_req(corpus, 0), now=2.5)
    assert h_again.done() and h_again.cached      # re-stored at 2.1


def test_cache_second_sight_admission(setup):
    corpus, index = setup
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=2, cache_size=8,
                        cache_admission="second_sight"))
    s.submit(_req(corpus, 0), now=0.0)
    s._execute(*s._pick_batch(0.01, True), now=0.01)
    st = s.stats()
    # first sighting: ghost-listed, not stored
    assert st["cache_admission_skips"] == 1 and st["cache_entries"] == 0
    h2 = s.submit(_req(corpus, 0), now=0.02)
    assert not h2.done()
    s._execute(*s._pick_batch(0.03, True), now=0.03)
    assert s.stats()["cache_entries"] == 1        # second sighting: stored
    h3 = s.submit(_req(corpus, 0), now=0.04)
    assert h3.done() and h3.cached
    with pytest.raises(ValueError, match="cache_admission"):
        Scheduler(
            index, RANK_SAFE, SchedulerConfig(cache_admission="bogus"))


# -- liveness / timeouts ------------------------------------------------------

def test_search_timeout_carries_routing_context(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))
    from repro_torch.serve.scheduler import SearchHandle
    h = SearchHandle(s, "long", 100, 0, 0.0)      # never submitted
    with pytest.raises(SearchTimeout, match="not served") as ei:
        h.result(timeout=0.01)
    assert ei.value.route == "long" and ei.value.k_bucket == 100
    assert isinstance(ei.value, TimeoutError)


def test_scheduler_survives_and_reports_worker_death(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE)
    s._record_executor_death(None, RuntimeError("boom"))
    st = s.stats()
    assert st["executor_deaths"] == 1
    assert st["dead_executors"] == {-1: "RuntimeError('boom')"}
    h = s.submit(_req(corpus, 0), now=0.0)        # still serves
    s.flush()
    assert h.result().ids.shape == (1, 10)


def test_pool_survives_injected_executor_death(setup):
    corpus, index = setup
    plan = FaultPlan([kill_executor(0)])
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=0, executors=2),
        faults=plan)
    with s:
        handles = [s.submit(_req(corpus, i % 8)) for i in range(12)]
        for h in handles:
            assert h.result(timeout=120.0).ids.shape == (1, 10)
    st = s.stats()
    assert st["completed"] == 12 and st["executor_deaths"] == 1
    assert 0 in st["dead_executors"]
    assert st["breakers"][0]["state"] == BREAKER_DEAD
    assert ("die", 0, None, None, None) in plan.fired
    assert _invariant(st)


def test_delivery_notifies_condition_waiters(setup):
    corpus, index = setup
    s = Scheduler(index, RANK_SAFE,
                  SchedulerConfig(max_batch=4, cache_size=0))

    class SpyCond(threading.Condition):
        notifies = 0

        def notify_all(self):
            SpyCond.notifies += 1
            super().notify_all()

    s._cond = SpyCond(s._lock)                    # shares the real lock
    h = s.submit(_req(corpus, 0), now=0.0)
    before = SpyCond.notifies
    s._execute(*s._pick_batch(0.01, True), now=0.01)
    # pick frees admission space and delivery wakes result()/blocked
    # submitters — both must notify, not rely on a poll timeout
    assert SpyCond.notifies >= before + 2
    assert h.done()


# -- fault plan ---------------------------------------------------------------

def test_fault_plan_validation_and_virtual_delay():
    with pytest.raises(ValueError, match="kind"):
        Fault("nope")
    plan = FaultPlan([delay_route("all", 7.5)])
    d = plan.on_batch(executor_id=None, batch_index=0, global_index=0,
                      route="all", generation=0)
    assert d == 7.5                               # virtual: no sleep
    assert plan.fired == [("delay", None, 0, "all", 0)]


def test_fault_plan_firing_log_is_deterministic(setup):
    corpus, index = setup

    def drive(plan):
        s = Scheduler(
            index, RANK_SAFE,
            SchedulerConfig(max_batch=2, cache_size=0,
                            retry=RetryPolicy(max_attempts=2,
                                              backoff_ms=1.0, jitter=0.0)),
            faults=plan)
        for i in range(4):
            s.submit(_req(corpus, i), now=0.001 * i)
        _drain(s, 0.1, step=0.01)
        return s.stats()

    p1 = FaultPlan([fail_batch(1), delay_route(None, 3.0, times=2)])
    p2 = FaultPlan([fail_batch(1), delay_route(None, 3.0, times=2)])
    st1, st2 = drive(p1), drive(p2)
    assert p1.fired == p2.fired
    assert [f[0] for f in p1.fired] == ["delay", "fail", "delay"]
    assert st1 == st2


# -- soak ---------------------------------------------------------------------

def test_fault_soak_mixed_stream_with_midstream_swap(setup):
    """The integration pin: a simulated-clock Poisson stream of mixed-k
    requests with injected failures (retryable, poison, delays), a
    too-tight deadline, and a mid-stream index hot-swap. Zero lost
    handles, the accounting invariant in every snapshot, and no
    cross-generation response."""
    corpus, index = setup
    plan = FaultPlan([poison_generation(0, times=1),
                      fail_batch(2), fail_batch(6),
                      delay_route(None, 5.0, times=4)])
    s = Scheduler(
        index, RANK_SAFE,
        SchedulerConfig(max_batch=4, cache_size=16,
                        retry=RetryPolicy(max_attempts=3, backoff_ms=1.0,
                                          jitter=0.0)),
        faults=plan)
    rng = np.random.default_rng(42)
    arrivals = np.cumsum(rng.exponential(1.0 / 400.0, 36))
    handles, pre_swap_done = [], set()
    t = 0.0
    for i in range(36):
        t = float(arrivals[i])
        if i == 18:
            # mid-stream hot swap; everything completed so far is gen 0
            pre_swap_done = {id(h) for h in handles
                             if h.done() and h._exception is None}
            assert all(h._response.generation == 0 for h in handles
                       if id(h) in pre_swap_done)
            assert s.swap_index(
                _build(corpus),
                warm=False) == 1
        if i == 9:
            # a hopeless deadline in its own micro-batch group (unique
            # query + threshold_factor, so no cache hit and no ride-along
            # on another group's dispatch): must expire, not execute
            handles.append(s.submit(SearchRequest(
                terms=corpus.queries[9], weights_b=corpus.q_weights_b[9],
                weights_l=corpus.q_weights_l[9], k=100,
                threshold_factor=0.9, deadline_ms=0.05), now=t))
        else:
            dl = 150.0 if i % 3 == 0 else None
            handles.append(s.submit(
                _req(corpus, i % 8, qlen=SHORT if i % 2 else None,
                     k=(10, 100)[i % 2], deadline_ms=dl), now=t))
        while True:
            picked = s._pick_batch(t, False)
            if picked is None:
                break
            try:
                s._execute(*picked, now=t)
            except InjectedFault:
                pass
        assert _invariant(s.stats())
    _drain(s, t)
    st = s.stats()
    assert all(h.done() for h in handles)         # zero lost handles
    assert st["pending"] == 0 and st["in_flight"] == 0
    assert (st["completed"] + st["failed"] + st["expired"]
            == st["submitted"] == 36)
    assert st["expired"] >= 1                     # the 0.05 ms deadline
    assert st["failed"] >= 1                      # the gen-0 poison
    assert st["retries"] >= 1 and st["swaps"] == 1
    assert _invariant(st)
    # generation safety: pre-swap completions are gen 0, everything
    # delivered after the flip (including cache hits) is gen 1
    for h in handles:
        if h._exception is not None:
            continue
        expect = 0 if id(h) in pre_swap_done else 1
        assert h._response.generation == expect
