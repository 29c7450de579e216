"""The port's serving-engine edge cases (``repro_torch.serve``), on the
CPU: the ``tests/test_serve_edges.py`` suite on the port (same names,
same assertions), every server on ``device="cpu"``.

Over-long queries (term truncation), partial final batches flushing on
drain, and zero batching delay accounting."""
import functools

import numpy as np
import pytest

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.serve import Request, RetrievalServer, ServerConfig

# the suites run on the CPU; the entry points default to "cuda"
Server = functools.partial(RetrievalServer, device="cpu")


@pytest.fixture(scope="module")
def served():
    # conftest's small_corpus, built by the port
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    index = build_index(corpus.merged("scaled"), tile_size=256,
                        device="cpu")
    return corpus, index


def _request(corpus, qi):
    return Request(corpus.queries[qi], corpus.q_weights_b[qi],
                   corpus.q_weights_l[qi])


def test_overlong_query_truncates_to_lowest_impact_terms(served):
    """A request with more terms than pad_terms keeps the highest
    gamma-combined-weight terms, and still returns a full result."""
    corpus, index = served
    params = twolevel.fast()
    pad = 4
    srv = Server(index, params, ServerConfig(max_batch=2,
                                             max_wait_ms=0.1,
                                             pad_terms=pad))
    # stitch two real queries into one 10-term request with hand-picked
    # weights: qw_b == qw_l makes the gamma-combined impact equal the raw
    # weight for ANY gamma, so the expected kept set is known a priori
    # (indices 1, 3, 6, 8) without re-deriving the production formula
    terms = np.concatenate([corpus.queries[0], corpus.queries[1]])
    w = np.array([.1, .9, .2, .8, .3, .4, .7, .05, .6, .15], np.float32)
    long_req = Request(terms, w.copy(), w.copy())
    srv.submit(long_req, 0.0)
    srv._flush()
    assert long_req.ids is not None and len(long_req.ids) == 10
    keep = np.array([1, 3, 6, 8])  # the four largest weights, in order
    short_req = Request(terms[keep], w[keep], w[keep])
    srv2 = Server(index, params, ServerConfig(pad_terms=pad))
    srv2.submit(short_req, 0.0)
    srv2._flush()
    np.testing.assert_array_equal(long_req.ids, short_req.ids)
    np.testing.assert_allclose(long_req.scores, short_req.scores)


def test_truncation_prefers_high_weight_over_leading_terms(served):
    """The kept set is weight-ranked, not positional: put the heavy terms
    last and check they survive."""
    corpus, index = served
    params = twolevel.fast()
    pad = 2
    nq = len(corpus.queries[0])
    terms = corpus.queries[0].copy()
    qw_b = np.ones(nq, np.float32) * 0.01
    qw_l = np.ones(nq, np.float32) * 0.01
    qw_b[-2:] = 5.0
    qw_l[-2:] = 5.0
    srv = Server(index, params, ServerConfig(pad_terms=pad))
    keep = srv._truncate(Request(terms, qw_b, qw_l))
    assert list(keep) == [nq - 2, nq - 1]


def test_partial_final_batch_flushes_on_drain(served):
    """Fewer pending requests than max_batch must still complete once the
    arrival stream ends (no stranded tail)."""
    corpus, index = served
    srv = Server(index, twolevel.fast(),
                 ServerConfig(max_batch=8, max_wait_ms=50.0))
    reqs = [_request(corpus, i % len(corpus.queries)) for i in range(3)]
    stats = srv.run_workload(reqs, qps=2000.0)
    assert stats["n"] == 3
    assert len(srv.completed) == 3
    assert all(r.ids is not None and r.t_done >= r.t_enqueue
               for r in srv.completed)


def test_multiple_partial_batches_drain_in_order(served):
    """max_batch=1 forces one flush per request; results keep arrival
    order and every latency is positive."""
    corpus, index = served
    srv = Server(index, twolevel.fast(),
                 ServerConfig(max_batch=1, max_wait_ms=0.0))
    reqs = [_request(corpus, i) for i in range(5)]
    stats = srv.run_workload(reqs, qps=1000.0)
    assert stats["n"] == 5
    lat = [r.latency_ms for r in srv.completed]
    assert all(v > 0 for v in lat)
    assert stats["p99_ms"] >= stats["p50_ms"]


def test_empty_workload_returns_zero_stats(served):
    """run_workload([]) must not reduce over empty latency arrays."""
    corpus, index = served
    srv = Server(index, twolevel.fast())
    stats = srv.run_workload([], qps=100.0)
    assert stats["n"] == 0
    assert stats["qps_achieved"] == 0.0
    assert np.isnan(stats["mrt_ms"]) and np.isnan(stats["p99_ms"])


def test_default_config_not_shared_across_servers(served):
    """The default ServerConfig must be per-instance: mutating one
    server's config cannot leak into another's."""
    corpus, index = served
    a = Server(index, twolevel.fast())
    b = Server(index, twolevel.fast())
    assert a.cfg is not b.cfg
    a.cfg.max_batch = 1
    assert b.cfg.max_batch == ServerConfig().max_batch


def test_empty_padded_request_is_harmless(served):
    """All-zero weights (fully padded request) completes without NaNs."""
    corpus, index = served
    srv = Server(index, twolevel.fast(), ServerConfig())
    req = Request(np.zeros(4, np.int32), np.zeros(4, np.float32),
                  np.zeros(4, np.float32))
    srv.submit(req, 0.0)
    srv._flush()
    assert req.ids is not None
    assert not np.isnan(req.scores).any()  # -inf padding ok, NaN never
