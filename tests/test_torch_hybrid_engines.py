"""The port's hybrid cascade/RRF engines (``repro_torch.retrieval.hybrid``,
``engines``) against the JAX package's, on the CPU.

``tests/test_hybrid_engines.py`` case for case (same names), on the port:
the substrate units, the registry engines against the primitives composed
by hand, mixed-k discipline, and the serving path (every scheduler on
``device="cpu"``). The reference's compile-once test becomes a check that
a within-bucket k sweep runs the first stage at one depth per bucket.

Added: cascade and rrf against the reference's engines over the same
carried state (``bridge.hybrid_index_from_arrays``: the reference's
sparse index, fp32 or q8, its dense side with its PCA basis, and its
``q_proj``), with every first stage (``batched``, ``kernel`` with
``chunked`` and ``chunked_fused``, ``sharded``): ids and first-stage stats
equal, scores within ``topk_scores_match``; the primitives against the
reference's; and a HybridIndex behind scheduler routes of every sparse
engine, ``sharded`` included.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import topk_scores_match
from repro.core import twolevel as jax_twolevel
from repro.eval import build_hybrid as jax_build_hybrid
from repro.eval import make_graded_corpus as jax_graded
from repro.index import compress_index as jax_compress
from repro.retrieval import Retriever as JaxRetriever
from repro.retrieval import hybrid as jhy
from repro_torch import bridge
from repro_torch.core import twolevel
from repro_torch.core.shard_plan import ShardedImpactIndex
from repro_torch.eval import build_hybrid, make_graded_corpus
from repro_torch.retrieval import (Retriever, SearchRequest,
                                   build_hybrid_index)
from repro_torch.retrieval.hybrid import (dense_topk, embed_queries,
                                          rerank_candidates, rrf_fuse)
from repro_torch.serve import (AsyncRetrievalScheduler, RoutingPolicy,
                               SchedulerConfig, route, single_route)

PARAMS = twolevel.fast()
CORPUS = dict(n_docs=1024, n_terms=512, n_queries=8, n_q_terms=5, dim=16,
              seed=5)


def _fields(x):
    return {f.name: (None if getattr(x, f.name) is None
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def graded():
    return make_graded_corpus(**CORPUS)


@pytest.fixture(scope="module")
def hybrid(graded):
    return build_hybrid(graded, tile_size=128, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """The reference's graded corpus and hybrid indexes (fp32 and q8 sparse
    sides over one dense side), and the port's copies of each."""
    jg = jax_graded(**CORPUS)
    jh = jax_build_hybrid(jg, tile_size=128)
    jq = dataclasses.replace(
        jh, sparse=jax_compress(jg.corpus.merged("scaled"), tile_size=128))
    dense, q_proj = _fields(jh.dense), np.asarray(jh.q_proj)
    return {"fp32": (jh, bridge.hybrid_index_from_arrays(
                _fields(jh.sparse), dense, q_proj, device="cpu")),
            "q8": (jq, bridge.hybrid_index_from_arrays(
                _fields(jq.sparse), dense, q_proj, device="cpu"))}


def _q(graded):
    return graded.queries()


def _req(graded, i, k=10, threshold_factor=None):
    c = graded.corpus
    return SearchRequest(terms=c.queries[i], weights_b=c.q_weights_b[i],
                         weights_l=c.q_weights_l[i], k=k,
                         threshold_factor=threshold_factor)


# -- substrate units ----------------------------------------------------------

def test_rrf_fuse_hand_example():
    """score(d) = sum 1/(60 + rank); agreement on both lists wins, ties
    break docid-ascending."""
    a = np.array([[1, 2, 3]])
    b = np.array([[2, 1, 9]])
    ids, scores = rrf_fuse(a, b, k=4, rrf_k=60.0)
    s1 = 1 / 61 + 1 / 62          # doc 1: rank 1 + rank 2
    s2 = 1 / 62 + 1 / 61          # doc 2: rank 2 + rank 1 (== s1)
    s3 = 1 / 63                   # single-list docs
    assert ids[0].tolist() == [1, 2, 3, 9]      # tie 1-vs-2: docid asc
    np.testing.assert_allclose(scores[0], [s1, s2, s3, s3], rtol=1e-6)
    want = jhy.rrf_fuse(a, b, k=4, rrf_k=60.0)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(scores, want[1])


def test_rrf_fuse_sentinels_and_padding():
    a = np.array([[4, -1, -1]])
    b = np.array([[-1, -1, -1]])
    ids, scores = rrf_fuse(a, b, k=3)
    assert ids[0].tolist() == [4, -1, -1]
    assert scores[0][0] == pytest.approx(1 / 61)
    assert np.isneginf(scores[0][1:]).all()
    with pytest.raises(ValueError, match="row mismatch"):
        rrf_fuse(np.zeros((2, 3)), np.zeros((3, 3)), k=2)
    # random rankings with sentinels and duplicates across the lists:
    # identical to the reference's outputs
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 40, (6, 20))
    b = rng.integers(-1, 40, (6, 20))
    for k, rrf_k in ((5, 60.0), (30, 7.5)):
        got, want = rrf_fuse(a, b, k, rrf_k), jhy.rrf_fuse(a, b, k, rrf_k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_build_hybrid_index_validates(hybrid):
    sparse = hybrid.sparse
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="original"):
        build_hybrid_index(sparse,
                           rng.standard_normal((sparse.n_docs - 1, 8)),
                           rng.standard_normal((sparse.n_terms, 8)),
                           device="cpu")
    with pytest.raises(ValueError, match="q_proj"):
        build_hybrid_index(sparse,
                           rng.standard_normal((sparse.n_docs, 8)),
                           rng.standard_normal((sparse.n_terms, 4)),
                           device="cpu")
    assert hybrid.to("cpu") is hybrid
    nb = hybrid.nbytes()
    assert nb["total"] == nb["sparse"] + nb["dense"] + nb["q_proj"]
    assert (hybrid.n_docs, hybrid.dim) == (1024, 16)


def test_embed_queries_dense_override_rotates(graded, hybrid, carried):
    """A caller-supplied embedding must land in the same rotated basis
    as the bridged one (exactly what the dense index's scorer expects)."""
    raw = np.asarray(
        (hybrid.q_proj.numpy()[graded.corpus.queries]
         * graded.corpus.q_weights_l[..., None]).sum(axis=-2))
    raw /= np.maximum(np.linalg.norm(raw, axis=1, keepdims=True), 1e-9)
    via_bridge = embed_queries(hybrid, graded.corpus.queries,
                               graded.corpus.q_weights_l)
    via_override = embed_queries(hybrid, None, None, dense=raw)
    np.testing.assert_allclose(via_bridge.numpy(), via_override.numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="B, 16"):
        embed_queries(hybrid, None, None,
                      dense=np.zeros((3, 7), np.float32))
    jh, th = carried["fp32"]
    c = graded.corpus
    np.testing.assert_allclose(
        embed_queries(th, c.queries, c.q_weights_l).numpy(),
        np.asarray(jhy.embed_queries(jh, c.queries, c.q_weights_l)),
        rtol=1e-5, atol=1e-6)


def test_rerank_sentinels_never_resurface(graded, hybrid, carried):
    q_rot = embed_queries(hybrid, graded.corpus.queries,
                          graded.corpus.q_weights_l)[:1]
    cands = np.array([[5, -1, 17, -1]], np.int32)
    scores, ids = rerank_candidates(hybrid, q_rot, cands, k=4)
    assert set(ids[0].tolist()) <= {5, 17, -1}
    assert (ids[0][:2] >= 0).all()              # two live candidates lead
    assert ids[0][2:].tolist() == [-1, -1]
    assert np.isneginf(scores[0][2:]).all()
    assert scores[0][0] >= scores[0][1]
    assert scores.dtype == np.float32 and ids.dtype == np.int32
    # the reference's rerank on the same state and candidates
    jh, th = carried["fp32"]
    c = graded.corpus
    jq = jhy.embed_queries(jh, c.queries, c.q_weights_l)
    tq = embed_queries(th, c.queries, c.q_weights_l)
    cands = np.random.default_rng(1).integers(-1, 1024, (8, 30))
    got = rerank_candidates(th, tq, cands, k=12)
    want = jhy.rerank_candidates(jh, jq, cands, k=12)
    np.testing.assert_array_equal(got[1], want[1])
    topk_scores_match(got[0], want[0])
    got = dense_topk(th, tq, k=50)
    want = jhy.dense_topk(jh, jq, k=50)
    np.testing.assert_array_equal(got[1], want[1])
    topk_scores_match(got[0], want[0])


# -- registry engines vs the primitives composed by hand ----------------------

def test_cascade_matches_manual_composition(graded, hybrid):
    r = Retriever.open(hybrid, PARAMS, engine="cascade", depth=100,
                       k_buckets=None, device="cpu")
    resp = r.search(**_q(graded), k=10)
    first = Retriever.open(hybrid, PARAMS, engine="batched",
                           k_buckets=None, device="cpu").search(
                               **_q(graded), k=100)
    q_rot = embed_queries(hybrid, graded.corpus.queries,
                          graded.corpus.q_weights_l)
    want_scores, want_ids = rerank_candidates(hybrid, q_rot, first.ids,
                                              k=10)
    np.testing.assert_array_equal(resp.ids, want_ids)
    np.testing.assert_allclose(resp.scores, want_scores, rtol=1e-6)
    assert resp.stats["cascade_depth"] == 100.0
    # every result is a first-stage candidate (cascade never invents docs)
    for row, cand in zip(resp.ids, first.ids):
        assert set(row.tolist()) <= set(cand.tolist()) | {-1}


def test_rrf_engine_matches_manual_fusion(graded, hybrid):
    r = Retriever.open(hybrid, PARAMS, engine="rrf", depth=100,
                       rrf_k=42.0, k_buckets=None, device="cpu")
    resp = r.search(**_q(graded), k=10)
    first = Retriever.open(hybrid, PARAMS, engine="batched",
                           k_buckets=None, device="cpu").search(
                               **_q(graded), k=100)
    q_rot = embed_queries(hybrid, graded.corpus.queries,
                          graded.corpus.q_weights_l)
    _, dense_ids = dense_topk(hybrid, q_rot, k=100)
    want_ids, want_scores = rrf_fuse(first.ids, dense_ids, k=10,
                                     rrf_k=42.0)
    np.testing.assert_array_equal(resp.ids, want_ids)
    np.testing.assert_allclose(resp.scores, want_scores, rtol=1e-6)
    assert resp.stats["rrf_k"] == 42.0 and resp.stats["fusion_depth"] == 100


def test_hybrid_engine_open_guards(graded, hybrid):
    with pytest.raises(TypeError, match="HybridIndex"):
        Retriever.open(hybrid.sparse, PARAMS, engine="cascade",
                       device="cpu")
    with pytest.raises(ValueError, match="first_stage"):
        Retriever.open(hybrid, PARAMS, engine="cascade",
                       first_stage="dense", device="cpu")
    with pytest.raises(ValueError, match="depth"):
        Retriever.open(hybrid, PARAMS, engine="rrf", depth=0, device="cpu")
    with pytest.raises(ValueError, match="rrf_k"):
        Retriever.open(hybrid, PARAMS, engine="rrf", rrf_k=0.0,
                       device="cpu")


def test_sparse_engines_unwrap_hybrid_index(graded, hybrid):
    """A HybridIndex opened under a sparse engine serves its .sparse side
    bit-identically: the contract that lets one scheduler index back a
    mixed sparse+hybrid routing policy."""
    for engine, opts in (("batched", {}), ("kernel", {}),
                         ("sequential", {"warmup": False}),
                         ("sharded", {"n_shards": 2})):
        via_hybrid = Retriever.open(hybrid, PARAMS, engine=engine,
                                    device="cpu", **opts).search(
                                        **_q(graded), k=10)
        via_sparse = Retriever.open(hybrid.sparse, PARAMS, engine=engine,
                                    device="cpu", **opts).search(
                                        **_q(graded), k=10)
        np.testing.assert_array_equal(via_hybrid.ids, via_sparse.ids)
        np.testing.assert_array_equal(via_hybrid.scores, via_sparse.scores)


def test_dense_engine_unwraps_hybrid_index(graded, hybrid):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    via_hybrid = Retriever.open(hybrid, twolevel.original(gamma=0.0),
                                engine="dense", device="cpu").search(
                                    dense=q, k=5)
    via_dense = Retriever.open(hybrid.dense, twolevel.original(gamma=0.0),
                               engine="dense", device="cpu").search(
                                   dense=q, k=5)
    np.testing.assert_array_equal(via_hybrid.ids, via_dense.ids)


# -- mixed-k and depth discipline ---------------------------------------------

@pytest.mark.parametrize("engine", ["cascade", "rrf"])
def test_mixed_k_batch_matches_per_row_calls(graded, engine, hybrid):
    r = Retriever.open(hybrid, PARAMS, engine=engine, depth=100,
                       device="cpu")
    ks = [3, 10, 5, 10, 7, 10, 2, 9]
    resp = r.search(**_q(graded), k=ks)
    assert resp.ks.tolist() == ks
    c = graded.corpus
    for i, k in enumerate(ks):
        solo = r.search(terms=c.queries[i:i + 1],
                        weights_b=c.q_weights_b[i:i + 1],
                        weights_l=c.q_weights_l[i:i + 1], k=k)
        np.testing.assert_array_equal(resp.ids[i, :k], solo.ids[0])
        assert (resp.ids[i, k:] == -1).all()
        assert np.isneginf(resp.scores[i, k:]).all()


def test_hybrid_compile_once_per_bucket_pair(graded, hybrid):
    """Within-bucket k sweeps and threshold_factor sweeps run the sparse
    first stage at one depth per bucket (the reference's jitted stages
    compile once per bucket pair): every search below runs it at k'=100,
    and a k past the bucket at the next bucket."""
    r = Retriever.open(hybrid, PARAMS, engine="cascade", depth=100,
                       device="cpu")
    seen = []
    search = r.engine.first.search

    def spy(*args, k, params):
        seen.append(k)
        return search(*args, k=k, params=params)
    r.engine.first.search = spy
    for k in (1, 5, 10, 42, 100):
        resp = r.search(**_q(graded), k=k, threshold_factor=1.0 + k / 10)
        assert resp.k_exec == (10 if k <= 10 else 100)
    r.search(**_q(graded), k=[3, 10, 5, 10, 7, 10, 2, 9])
    assert seen == [100] * 6
    r.search(**_q(graded), k=101)
    assert seen[-1] == 1000 and len(seen) == 7


# -- against the reference's engines on the same state --------------------------

FIRST_STAGES = {"batched": {}, "kernel_chunked": {
    "first_stage": "kernel", "traversal": "chunked"},
    "kernel_chunked_fused": {"first_stage": "kernel",
                             "traversal": "chunked_fused"},
    "sharded": {"first_stage": "sharded", "n_shards": 2}}
FIRST_STAGE_STATS = ("docs_present", "docs_survived", "docs_frozen",
                     "postings_touched", "tiles_visited")


@pytest.mark.parametrize("stage", sorted(FIRST_STAGES))
@pytest.mark.parametrize("kind", ["fp32", "q8"])
@pytest.mark.parametrize("engine", ["cascade", "rrf"])
def test_hybrid_engine_matches_reference(graded, carried, engine, kind,
                                         stage):
    jh, th = carried[kind]
    opts = dict(FIRST_STAGES[stage], depth=100)
    if engine == "rrf":
        opts["rrf_k"] = 30.0
    jr = JaxRetriever.open(jh, jax_twolevel.fast(), engine=engine, **opts)
    tr = Retriever.open(th, PARAMS, engine=engine, device="cpu", **opts)
    for k in (10, 100):
        want = jr.search(**_q(graded), k=k)
        got = tr.search(**_q(graded), k=k)
        np.testing.assert_array_equal(got.ids, want.ids)
        topk_scores_match(got.scores, want.scores)
        assert set(got.stats) == set(want.stats)
        for key in FIRST_STAGE_STATS + ("cascade_depth", "fusion_depth",
                                        "chunks_dispatched",
                                        "shard_tiles_visited"):
            if key in want.stats:
                np.testing.assert_array_equal(np.asarray(got.stats[key]),
                                              np.asarray(want.stats[key]))


def test_hybrid_dense_override_matches_reference(graded, carried):
    """``SearchRequest.dense`` replaces the q_proj bridge in both engines
    of both packages alike."""
    jh, th = carried["fp32"]
    q = np.random.default_rng(2).standard_normal((8, 16)).astype(np.float32)
    for engine in ("cascade", "rrf"):
        want = JaxRetriever.open(jh, jax_twolevel.fast(),
                                 engine=engine).search(
                                     **_q(graded), dense=jnp.asarray(q),
                                     k=10)
        got = Retriever.open(th, PARAMS, engine=engine,
                             device="cpu").search(**_q(graded), dense=q,
                                                  k=10)
        np.testing.assert_array_equal(got.ids, want.ids)
        topk_scores_match(got.scores, want.scores)


# -- the serving path ---------------------------------------------------------

@pytest.mark.parametrize("engine", ["cascade", "rrf"])
def test_scheduler_serves_hybrid_engine_mixed_k(graded, engine, hybrid):
    """A mixed-k stream through the scheduler bit-matches direct
    Retriever calls: hybrid engines ride the sparse serving path with no
    request-format change (embeddings come from the q_proj bridge)."""
    s = AsyncRetrievalScheduler(
        hybrid, PARAMS, SchedulerConfig(max_batch=4, cache_size=0),
        routing=single_route(engine, depth=100), device="cpu")
    direct = Retriever.open(hybrid, PARAMS, engine=engine, depth=100,
                            device="cpu")
    ks = [10, 3, 7, 10, 5, 9]
    handles = [s.submit(_req(graded, i, k=k)) for i, k in enumerate(ks)]
    s.flush()
    c = graded.corpus
    for i, (h, k) in enumerate(zip(handles, ks)):
        resp = h.result()
        assert resp.engine == engine and resp.ids.shape == (1, k)
        solo = direct.search(terms=c.queries[i:i + 1],
                             weights_b=c.q_weights_b[i:i + 1],
                             weights_l=c.q_weights_l[i:i + 1], k=k)
        np.testing.assert_array_equal(resp.ids[0], solo.ids[0])
        np.testing.assert_allclose(resp.scores[0], solo.scores[0],
                                   rtol=1e-6)


def test_scheduler_mixed_sparse_hybrid_policy(graded, hybrid):
    """One HybridIndex backs a policy that routes short queries to the
    sparse engine and long ones to cascade."""
    policy = RoutingPolicy((
        route("short", 3, "batched", pad_terms=3),
        route("long", None, "cascade", depth=100)))
    s = AsyncRetrievalScheduler(hybrid, PARAMS,
                                SchedulerConfig(max_batch=4, cache_size=0),
                                routing=policy, device="cpu")
    c = graded.corpus
    short = SearchRequest(terms=c.queries[0][:3],
                          weights_b=c.q_weights_b[0][:3],
                          weights_l=c.q_weights_l[0][:3], k=5)
    hs, hl = s.submit(short), s.submit(_req(graded, 1, k=5))
    s.flush()
    assert hs.route == "short" and hs.result().engine == "batched"
    assert hl.route == "long" and hl.result().engine == "cascade"


@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("kernel", {"traversal": "chunked_fused"}),
    ("sequential", {"warmup": False}), ("sharded", {"n_shards": 2}),
    ("cascade", {"first_stage": "sharded", "n_shards": 2})])
def test_scheduler_serves_hybrid_index_on_every_route(graded, hybrid,
                                                      engine, opts):
    """A HybridIndex behind a route of every sparse engine (the sharded
    route partitions its sparse side) and of a cascade with a sharded first
    stage, in a 2-executor pool: each response equals a direct search."""
    s = AsyncRetrievalScheduler(
        hybrid, PARAMS, SchedulerConfig(max_batch=4, cache_size=0,
                                        executors=2),
        routing=single_route(engine, **opts), device="cpu")
    with s:
        handles = [s.submit(_req(graded, i, k=10)) for i in range(8)]
        resps = [h.result(timeout=60) for h in handles]
    direct = Retriever.open(hybrid, PARAMS, engine=engine, device="cpu",
                            **opts)
    c = graded.corpus
    for i, resp in enumerate(resps):
        solo = direct.search(terms=c.queries[i:i + 1],
                             weights_b=c.q_weights_b[i:i + 1],
                             weights_l=c.q_weights_l[i:i + 1], k=10)
        assert resp.engine == engine
        np.testing.assert_array_equal(resp.ids[0], solo.ids[0])
    if engine == "sharded":       # one partition, of the sparse side
        (part,) = s._partitions.values()
        assert isinstance(part, ShardedImpactIndex)
        assert part.n_docs == hybrid.sparse.n_docs


def test_cache_distinguishes_hybrid_engines(graded, hybrid):
    """Identical queries served by different engines must never share a
    response-cache entry: the policy fingerprint (part of every cache
    key) pins the engine and its options."""
    fp_c = single_route("cascade", depth=100).fingerprint(PARAMS)
    fp_r = single_route("rrf", depth=100).fingerprint(PARAMS)
    fp_r2 = single_route("rrf", depth=100, rrf_k=10.0).fingerprint(PARAMS)
    assert len({fp_c, fp_r, fp_r2}) == 3
    # and a same-engine resubmit is a genuine hit
    s = AsyncRetrievalScheduler(
        hybrid, PARAMS, SchedulerConfig(max_batch=2, cache_size=8),
        routing=single_route("cascade", depth=100), device="cpu")
    s.submit(_req(graded, 0, k=5))
    s.flush()
    h = s.submit(_req(graded, 0, k=5))
    assert h.cached and h.done()
    assert s.stats()["cache_hits"] == 1
    # different engine opts -> different scheduler key -> miss
    s2 = AsyncRetrievalScheduler(
        hybrid, PARAMS, SchedulerConfig(max_batch=2, cache_size=8),
        routing=single_route("cascade", depth=1000), device="cpu")
    h2 = s2.submit(_req(graded, 0, k=5))
    assert not h2.done()
    s2.flush()
    np.testing.assert_array_equal(h2.result().ids.shape, (1, 5))
