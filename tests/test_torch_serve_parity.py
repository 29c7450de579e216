"""The port's serving layer against the JAX package's, on the CPU.

The same 48-request mixed stream (``mixed_request_stream``: 3- and
5-term queries, k 10 and 100, five queries repeating so the response
cache serves most of the later rounds) goes through ``repro.serve``'s
``AsyncRetrievalScheduler`` and the port's (``device="cpu"``) under the
same routing policy and config, in four rounds of 12 submissions each
followed by a flush. Every handle must agree: route, k-bucket, cache
flag, ids equal, scores within ``topk_scores_match``, per-row depths and
per-query stats equal; and every ``stats()`` counter that is not a time
must be equal. Cases: the ``batched`` engine (full scan) and the
``kernel`` engine (``chunked`` and ``chunked_fused``), each under
``original(gamma=0.2)`` (rank-safe) and ``fast()``.

The fault-handling pieces are pure functions of their inputs: the retry
backoff schedule and the breaker transitions on a simulated clock must
be equal, step by step.
"""
import numpy as np
import pytest

from conftest import topk_scores_match
from repro.core import build_index as jax_build_index
from repro.core import twolevel as jax_twolevel
from repro.serve import AsyncRetrievalScheduler as JaxScheduler
from repro.serve import HealthConfig as JaxHealthConfig
from repro.serve import HealthMonitor as JaxHealthMonitor
from repro.serve import RetryPolicy as JaxRetryPolicy
from repro.serve import RoutingPolicy as JaxRoutingPolicy
from repro.serve import SchedulerConfig as JaxSchedulerConfig
from repro.serve import mixed_request_stream as jax_stream
from repro.serve import route as jax_route
from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.serve import (AsyncRetrievalScheduler, HealthConfig,
                               HealthMonitor, RetryPolicy, RoutingPolicy,
                               SchedulerConfig, mixed_request_stream, route)

SHORT, LONG = 3, 5
ROUNDS, PER_ROUND = 4, 12
# stats() entries that are times, not counts
TIMED = ("warmup_s", "queue_wait_ms", "service_ms")
PRESETS = {"original": (twolevel.original(gamma=0.2),
                        jax_twolevel.original(gamma=0.2)),
           "fast": (twolevel.fast(), jax_twolevel.fast())}


@pytest.fixture(scope="module")
def setup(small_corpus):
    # conftest's small_corpus, built by each package
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    index = build_index(corpus.merged("scaled"), tile_size=256,
                        device="cpu")
    jindex = jax_build_index(small_corpus.merged("scaled"), tile_size=256)
    return corpus, index, small_corpus, jindex


def _serve(scheduler, stream):
    """Submit the stream in rounds, flushing after each; the handles."""
    handles = []
    for r in range(ROUNDS):
        handles += [scheduler.submit(req)
                    for req in stream[r * PER_ROUND:(r + 1) * PER_ROUND]]
        scheduler.flush()
    return handles


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("kernel", {"traversal": "chunked"}),
    ("kernel", {"traversal": "chunked_fused"})],
    ids=["batched", "kernel-chunked", "kernel-chunked_fused"])
def test_mixed_stream_matches_reference_scheduler(setup, engine, opts,
                                                  preset):
    corpus, index, jcorpus, jindex = setup
    params, jparams = PRESETS[preset]
    cfg = dict(max_batch=4, pad_terms=LONG, cache_size=64)
    port = AsyncRetrievalScheduler(
        index, params, SchedulerConfig(**cfg),
        routing=RoutingPolicy((
            route("short", SHORT, engine, pad_terms=SHORT, **opts),
            route("long", None, engine, **opts))),
        k_buckets=(10, 100), device="cpu")
    ref = JaxScheduler(
        jindex, jparams, JaxSchedulerConfig(**cfg),
        routing=JaxRoutingPolicy((
            jax_route("short", SHORT, engine, pad_terms=SHORT, **opts),
            jax_route("long", None, engine, **opts))),
        k_buckets=(10, 100))
    stream = dict(short_len=SHORT, k_pool=(10, 100), query_pool=5)
    got = _serve(port, mixed_request_stream(corpus, ROUNDS * PER_ROUND,
                                            **stream))
    want = _serve(ref, jax_stream(jcorpus, ROUNDS * PER_ROUND, **stream))
    assert sum(h.cached for h in got) > 0
    for i, (h, jh) in enumerate(zip(got, want)):
        assert (h.route, h.k_bucket, h.cached) == (jh.route, jh.k_bucket,
                                                   jh.cached), i
        a, b = h.result(), jh.result()
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"request {i}")
        topk_scores_match(a.scores, b.scores)
        np.testing.assert_array_equal(a.ks, b.ks)
        assert (a.k, a.k_exec, a.engine, a.generation, a.degraded) == (
            b.k, b.k_exec, b.engine, b.generation, b.degraded)
        assert set(a.stats) == set(b.stats)
        for key in a.stats:
            np.testing.assert_array_equal(a.stats[key], b.stats[key],
                                          err_msg=f"request {i} {key}")
    st, jst = port.stats(), ref.stats()
    assert set(st) == set(jst)
    for key in set(st) - set(TIMED):
        assert st[key] == jst[key], key
    assert st["cache_hits"] > 0 and st["batches"] >= ROUNDS


def test_retry_backoff_schedule_matches_reference():
    for kw in (dict(), dict(backoff_ms=100.0, backoff_factor=2.0,
                            jitter=0.5, seed=3),
               dict(backoff_ms=10.0, backoff_factor=3.0, jitter=0.0),
               dict(backoff_ms=1.0, jitter=0.9, seed=11)):
        p, jp = RetryPolicy(**kw), JaxRetryPolicy(**kw)
        for token in (0, 1, 9, 123, 2 ** 40):
            for attempt in range(0, 6):
                assert (p.delay_ms(attempt, token=token)
                        == jp.delay_ms(attempt, token=token)), (kw, token,
                                                                 attempt)


def test_breaker_transitions_match_reference_on_simulated_clock():
    """One scripted run of failures, successes, gate checks and a death
    across three executors, on a simulated clock: after every step both
    monitors report the same states, gate answers, snapshots, degraded
    flag and hedge-delay p99."""
    cfg = dict(failure_threshold=2, cooldown_ms=100.0, ewma_decay=0.6,
               window=8)
    hm, jhm = HealthMonitor(HealthConfig(**cfg)), JaxHealthMonitor(
        JaxHealthConfig(**cfg))
    rng = np.random.default_rng(0)
    now = 0.0
    seen = set()
    for step in range(300):
        now += float(rng.uniform(0.0, 0.06))
        eid = int(rng.integers(0, 3))
        op = rng.choice(["fail", "ok", "allow", "allow"])
        if step == 250:
            op = "dead"
        if op == "fail":
            hm.record_failure(eid, now)
            jhm.record_failure(eid, now)
        elif op == "ok":
            ms = float(rng.uniform(1.0, 50.0))
            hm.record_success(eid, ms, now)
            jhm.record_success(eid, ms, now)
        elif op == "dead":
            hm.mark_dead(eid)
            jhm.mark_dead(eid)
        else:
            assert hm.allow(eid, now) == jhm.allow(eid, now), step
        states = [hm.state(e) for e in range(3)]
        assert states == [jhm.state(e) for e in range(3)], step
        seen.update(states)
        assert hm.snapshot() == jhm.snapshot(), step
        assert hm.degraded() == jhm.degraded()
        assert hm.latency_p99_ms(7.0) == jhm.latency_p99_ms(7.0)
    assert seen == {"closed", "open", "half_open", "dead"}
