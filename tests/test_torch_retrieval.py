"""The port's search API against the JAX package's, and the port's
independence from JAX.

``Retriever.search`` is a facade over the engines: for the same request
(mixed per-row k, ragged queries, threshold override) it must return what
the reference's ``Retriever`` returns: ids equal, scores within
``topk_scores_match``, per-row depths and stat counters equal. The
``sharded`` engine's cases of ``tests/test_retrieval_api.py`` hold it
against the reference's ``sharded`` engine and, inside the port, against
the legacy entry point (``serve.sharded.shard_retrieve_batched``) bit for
bit.

The port compiles nothing at run time (no ``torch.compile``, no CUDA
graphs), so the reference's compile-once-per-bucket tests have no
counterpart here."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import topk_scores_match
from repro.core import build_index as jax_build_index
from repro.core import twolevel as jax_twolevel
from repro.retrieval import Retriever as JaxRetriever
from repro.core.shard_plan import shard_index as jax_shard_index
from repro_torch import bridge
from repro_torch.core import twolevel
from repro_torch.core.shard_plan import shard_index
from repro_torch.core.traversal import STAT_KEYS
from repro_torch.retrieval import (K_BUCKETS, Retriever, SearchRequest,
                                   bucket_k, engine_names, get_engine)
from repro_torch.serve.sharded import shard_retrieve_batched

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def setup(small_corpus):
    jidx = jax_build_index(small_corpus.merged("scaled"), tile_size=256)
    tidx = bridge.index_from_arrays(
        {f.name: (None if getattr(jidx, f.name) is None
                  else np.asarray(getattr(jidx, f.name)))
         for f in dataclasses.fields(jidx)}, device="cpu")
    return small_corpus, jidx, tidx


def _q(corpus, rows=slice(None)):
    return dict(terms=corpus.queries[rows],
                weights_b=corpus.q_weights_b[rows],
                weights_l=corpus.q_weights_l[rows])


def _assert_responses_match(ref, port):
    np.testing.assert_array_equal(ref.ids, port.ids)
    topk_scores_match(port.scores, ref.scores)
    np.testing.assert_array_equal(ref.ks, port.ks)
    assert (ref.k, ref.k_exec, ref.engine) == (port.k, port.k_exec,
                                               port.engine)
    for key in STAT_KEYS:
        np.testing.assert_array_equal(ref.stats[key], port.stats[key])


@pytest.mark.parametrize("engine,opts", [
    ("batched", {}), ("batched", {"traversal": "chunked"}),
    ("kernel", {"traversal": "chunked_fused", "chunk_tiles": 2}),
    ("sharded", {"n_shards": 2}),
    ("sharded", {"n_shards": 3, "traversal": "chunked", "chunk_tiles": 2,
                 "use_kernel": True, "exchange_every": 2})])
def test_mixed_k_search_matches_reference(setup, engine, opts):
    """One batch, per-row depths across two buckets: the engine runs once
    at the largest row's bucket and masks each row past its own k."""
    corpus, jidx, tidx = setup
    ks = [5, 10, 42, 100, 7, 10, 1, 64, 10, 3, 99, 12]
    ref = JaxRetriever.open(jidx, jax_twolevel.fast(), engine=engine,
                            **opts).search(**_q(corpus), k=ks)
    port = Retriever.open(tidx, twolevel.fast(), engine=engine,
                          device="cpu", **opts).search(**_q(corpus), k=ks)
    _assert_responses_match(ref, port)
    assert port.k == 100 and port.k_exec == 100
    assert (port.ids[0, 5:] == -1).all()
    assert np.isneginf(port.scores[0, 5:]).all()


def test_ragged_request_and_threshold_override_match_reference(setup):
    corpus, jidx, tidx = setup
    terms = [corpus.queries[i, :n] for i, n in enumerate([5, 3, 1, 4])]
    wb = [corpus.q_weights_b[i, :len(t)] for i, t in enumerate(terms)]
    wl = [corpus.q_weights_l[i, :len(t)] for i, t in enumerate(terms)]
    req = dict(terms=terms, weights_b=wb, weights_l=wl, k=10,
               threshold_factor=1.3)
    ref = JaxRetriever.open(jidx, jax_twolevel.gti(), engine="kernel",
                            traversal="chunked").search(**req)
    port = Retriever.open(tidx, twolevel.gti(), engine="kernel",
                          traversal="chunked", device="cpu").search(**req)
    _assert_responses_match(ref, port)


def test_sequential_engine_matches_batched(setup):
    corpus, _, tidx = setup
    q = _q(corpus, slice(0, 3))
    seq = Retriever.open(tidx, twolevel.fast(), engine="sequential",
                         device="cpu", warmup=False).search(**q, k=10)
    bat = Retriever.open(tidx, twolevel.fast(), device="cpu").search(
        **q, k=10)
    np.testing.assert_array_equal(seq.ids, bat.ids)
    assert seq.latencies_ms.shape == (3,)


def test_registry_and_engine_options(setup):
    _, _, tidx = setup
    assert engine_names() == ("batched", "cascade", "dense", "kernel",
                              "rrf", "sequential", "sharded")
    with pytest.raises(KeyError, match="batched"):
        get_engine("bm25")
    with pytest.raises(ValueError, match="traversal"):
        Retriever.open(tidx, engine="batched", traversal="chunked_fused",
                       device="cpu")
    with pytest.raises(TypeError, match="BlockedImpactIndex or "
                       "CompressedImpactIndex"):
        Retriever.open(object(), device="cpu")
    r = Retriever.open(tidx, twolevel.fast(), engine="kernel",
                       traversal="chunked", chunk_tiles=2, device="cpu")
    rep = r.replicate()
    assert rep.engine is not r.engine
    assert rep.engine.index is r.engine.index          # shared tensors
    assert (rep.engine.traversal, rep.engine.chunk_tiles) == ("chunked", 2)
    assert bucket_k(11, K_BUCKETS) == 100 and bucket_k(2000) == 2000


def test_request_object_tensors_and_validation(setup):
    corpus, _, tidx = setup
    r = Retriever.open(tidx, twolevel.fast(), device="cpu")
    q = _q(corpus, slice(0, 3))
    a = r.search(SearchRequest(**q, k=10))
    b = r.search(terms=torch.from_numpy(q["terms"]).long(),
                 weights_b=torch.from_numpy(q["weights_b"]),
                 weights_l=torch.from_numpy(q["weights_l"]), k=10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    with pytest.raises(TypeError, match="either"):
        r.search(SearchRequest(**q), k=5)
    with pytest.raises(ValueError, match="entries"):
        r.search(**q, k=[5, 10])
    with pytest.raises(ValueError, match="whole"):
        r.search(**q, k=[5.5, 10, 10])
    with pytest.raises(ValueError, match="flat"):
        r.search(terms=[1, 2, 3], weights_b=[1, 1, 1], weights_l=[1, 1, 1])


def test_open_on_cuda_without_gpu_raises(setup):
    _, _, tidx = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Retriever.open(tidx, twolevel.fast())          # device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        Retriever.open(tidx, twolevel.fast(), engine="sharded", n_shards=2)


# -- the sharded engine (tests/test_retrieval_api.py's sharded cases) ---------

def test_every_engine_serves_a_request_sharded(setup):
    """Registry smoke on the sharded engine: the uniform response shape."""
    corpus, _, tidx = setup
    r = Retriever.open(tidx, twolevel.fast(), engine="sharded",
                       device="cpu")
    resp = r.search(**_q(corpus), k=5)
    assert resp.engine == "sharded"
    assert resp.k == 5 and resp.k_exec == 10
    assert resp.ids.shape == resp.scores.shape == (resp.ids.shape[0], 5)
    assert resp.latency_ms > 0
    assert resp.stats


def test_traversal_knob_serves_and_reports_chunks_sharded(setup):
    """The chunked knob opens through the facade on the sharded engine and
    surfaces chunks_dispatched, equal to the reference's."""
    corpus, jidx, tidx = setup
    opts = dict(traversal="chunked", n_shards=2)
    ref = JaxRetriever.open(jidx, jax_twolevel.fast().replace(chunk_tiles=2),
                            engine="sharded", **opts).search(**_q(corpus),
                                                             k=5)
    resp = Retriever.open(tidx, twolevel.fast().replace(chunk_tiles=2),
                          engine="sharded", device="cpu", **opts).search(
        **_q(corpus), k=5)
    assert resp.ids.shape == (len(corpus.queries), 5)
    assert (resp.stats["chunks_dispatched"]
            <= resp.stats["n_chunks"]).all()
    _assert_responses_match(ref, resp)
    for key in ("chunks_dispatched", "n_chunks", "shard_chunks_dispatched",
                "shard_tiles_visited"):
        np.testing.assert_array_equal(resp.stats[key],
                                      np.asarray(ref.stats[key]))


def test_unsupported_traversal_raises_at_open_sharded(setup):
    _, _, tidx = setup
    with pytest.raises(ValueError, match="traversal"):
        Retriever.open(tidx, twolevel.fast(), engine="sharded",
                       traversal="chunked_fused", n_shards=2, device="cpu")


@pytest.mark.parametrize("params,jparams", [
    (twolevel.original(gamma=0.2), jax_twolevel.original(gamma=0.2)),
    (twolevel.fast(), jax_twolevel.fast())], ids=["rank_safe", "guided"])
def test_sharded_matches_legacy(setup, params, jparams):
    """The sharded engine == the legacy entry point bit for bit, and ==
    the reference's sharded engine (ids, stats; scores within
    ``topk_scores_match``)."""
    corpus, jidx, tidx = setup
    sh = shard_index(tidx, 3, device="cpu")
    ref = shard_retrieve_batched(sh, corpus.queries, corpus.q_weights_b,
                                 corpus.q_weights_l, params, k=10)
    resp = Retriever.open(tidx, params, engine="sharded", n_shards=3,
                          device="cpu").search(**_q(corpus), k=10)
    np.testing.assert_array_equal(resp.ids, ref.ids)
    np.testing.assert_array_equal(resp.scores, ref.scores)
    _assert_responses_match(
        JaxRetriever.open(jidx, jparams, engine="sharded",
                          n_shards=3).search(**_q(corpus), k=10), resp)


def test_sharded_accepts_prebuilt_shard_plan(setup):
    corpus, jidx, tidx = setup
    p = twolevel.fast()
    sh = shard_index(tidx, 4, device="cpu")
    a = Retriever.open(tidx, p, engine="sharded", n_shards=4,
                       device="cpu").search(**_q(corpus), k=10)
    r = Retriever.open(sh, p, engine="sharded", device="cpu")
    assert r.engine.sharded is sh                     # no re-partition
    b = r.search(**_q(corpus), k=10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    _assert_responses_match(
        JaxRetriever.open(jax_shard_index(jidx, 4), jax_twolevel.fast(),
                          engine="sharded").search(**_q(corpus), k=10), b)


@pytest.mark.parametrize("k", [5, 10, 100])
def test_bucketed_k_rank_safe_parity_sharded(setup, k):
    """k in {5, 10, 100} through the bucketing path == the legacy entry
    point at exactly k (rank-safe: exact top-k is prefix-closed)."""
    corpus, _, tidx = setup
    params = twolevel.original(gamma=0.2)
    ref = shard_retrieve_batched(
        shard_index(tidx, 2, device="cpu"), corpus.queries,
        corpus.q_weights_b, corpus.q_weights_l, params, k=k)
    resp = Retriever.open(tidx, params, engine="sharded", n_shards=2,
                          device="cpu").search(**_q(corpus), k=k)
    assert resp.k_exec == bucket_k(k)
    np.testing.assert_array_equal(resp.ids, ref.ids[:, :k])
    np.testing.assert_array_equal(resp.scores, ref.scores[:, :k])


def test_mixed_k_batch_matches_per_k_calls_sharded(setup):
    """One batch with k in {5, 10, 100} on the sharded engine: each row's
    prefix is bit-identical to a separate call at that row's own k;
    slots beyond a row's depth hold the empty sentinels."""
    corpus, _, tidx = setup
    mixed = [5, 10, 100]
    r = Retriever.open(tidx, twolevel.original(gamma=0.2), engine="sharded",
                       n_shards=2, device="cpu")
    n = len(mixed)
    resp = r.search(**_q(corpus, slice(0, n)), k=mixed)
    assert resp.k == 100 and resp.k_exec == 100
    np.testing.assert_array_equal(resp.ks, mixed)
    for i, ki in enumerate(mixed):
        single = r.search(**_q(corpus, slice(i, i + 1)), k=ki)
        np.testing.assert_array_equal(resp.ids[i, :ki], single.ids[0])
        np.testing.assert_array_equal(resp.scores[i, :ki], single.scores[0])
        assert (resp.ids[i, ki:] == -1).all()
        assert np.isneginf(resp.scores[i, ki:]).all()


def test_port_imports_and_searches_without_jax_or_reference(tmp_path):
    """repro_torch runs with ``jax`` and ``repro`` unimportable: a finder
    that refuses both is installed before anything is imported; it builds
    and searches the fp32 and the compressed (q8) index (also through the
    ``sharded`` engine and a 2-shard ``ShardedRetrievalServer``, with the
    collectives on a gloo group of one rank), streams a 2-chunk
    q8 build through ``StreamingIndexBuilder`` and serves it through a
    ``Retriever`` opened with a metrics registry (``repro_torch.obs``),
    reads the trace attributes (``obs.trace_exec``), flushes a 2-route
    scheduler and serves a stream through a 2-executor pool
    (``repro_torch.serve``), builds a hybrid index over a graded corpus
    and searches it through the ``dense``, ``cascade`` and ``rrf`` engines
    and scores a ranking through ``repro_torch.eval``, and runs a smoke LM
    decode step and a smoke DLRM serve step."""
    script = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        from repro_torch.core import build_index, twolevel
        from repro_torch.data import make_corpus
        from repro_torch.index import compress_index
        from repro_torch.retrieval import Retriever

        c = make_corpus("splade_like", n_docs=1024, n_terms=256,
                        n_queries=4, n_q_terms=4, avg_doc_terms=16, seed=3)
        merged = c.merged("scaled")
        for index in (build_index(merged, tile_size=256, device="cpu"),
                      compress_index(merged, tile_size=256, device="cpu")):
            for opts in ({"traversal": "chunked_fused"},
                         {"traversal": "chunked"}):
                r = Retriever.open(index, twolevel.fast(), engine="kernel",
                                   device="cpu", **opts)
                resp = r.search(terms=c.queries, weights_b=c.q_weights_b,
                                weights_l=c.q_weights_l, k=10)
                assert resp.ids.shape == (4, 10)
                assert np.isfinite(resp.scores).all()
        assert index.gather_kind == "q8"

        import tempfile
        import torch
        import torch.distributed as dist
        from repro_torch.core.shard_plan import shard_index
        from repro_torch.dist import ring_all_reduce
        from repro_torch.serve import (Request, ShardedRetrievalServer,
                                       make_shard_mesh)
        for traversal in ("full", "chunked"):
            r = Retriever.open(index, twolevel.fast(), engine="sharded",
                               n_shards=3, use_kernel=True,
                               traversal=traversal, exchange_every=2,
                               device="cpu")
            resp = r.search(terms=c.queries, weights_b=c.q_weights_b,
                            weights_l=c.q_weights_l, k=10)
            assert resp.stats["shard_tiles_visited"].shape == (4, 3)
        srv = ShardedRetrievalServer(index, twolevel.fast(), n_shards=2,
                                     device="cpu")
        srv.submit(Request(c.queries[0], c.q_weights_b[0],
                           c.q_weights_l[0]), 0.0)
        while srv.pending:
            srv._flush()
        assert srv.completed[0].ids.shape == (10,)
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group(
                "gloo", store=dist.FileStore(d + "/store", 1), rank=0,
                world_size=1)
            one = shard_index(index, 1, device="cpu")
            a = Retriever.open(one, twolevel.fast(), engine="sharded",
                               mesh=make_shard_mesh(1), device="cpu")
            b = Retriever.open(one, twolevel.fast(), engine="sharded",
                               device="cpu")
            q = dict(terms=c.queries, weights_b=c.q_weights_b,
                     weights_l=c.q_weights_l, k=10)
            assert np.array_equal(a.search(**q).ids, b.search(**q).ids)
            assert ring_all_reduce(torch.ones(2)).tolist() == [1.0, 1.0]
            dist.destroy_process_group()

        import tempfile
        import torch
        from repro_torch.data import StreamingIndexBuilder
        from repro_torch.obs import MetricsRegistry, prometheus_text
        from repro_torch.obs import trace_exec
        with tempfile.TemporaryDirectory() as d:
            b = StreamingIndexBuilder(d, n_terms=256, tile_size=256,
                                      chunk_docs=512)
            for ch in c.iter_chunks(512):
                assert b.add_chunk(ch)
            streamed = b.finalize(device="cpu")
        assert b.completed_chunks == [0, 1]
        assert all(torch.equal(getattr(streamed, f), getattr(index, f))
                   for f in ("packed", "qb", "ql", "tile_ptr", "first"))
        reg = MetricsRegistry()
        r = Retriever.open(streamed, twolevel.fast(), engine="kernel",
                           traversal="chunked_fused", device="cpu",
                           metrics=reg)
        for k in (10, 100):
            resp = r.search(terms=c.queries, weights_b=c.q_weights_b,
                            weights_l=c.q_weights_l, k=k)
        assert reg.histogram("search_ms/kernel").n == 2
        assert "repro_search_ms_kernel_count 2" in prometheus_text(reg)
        attrs = trace_exec.request_attributes(resp.stats)
        assert attrs["n_chunks"] >= attrs["chunks_dispatched"] >= 1

        from repro_torch.serve import (AsyncRetrievalScheduler,
                                       SchedulerConfig, mixed_request_stream,
                                       run_workload, table8_policy)
        policy = table8_policy(short_max_len=2, long_engine="kernel",
                               long_traversal="chunked_fused")
        stream = mixed_request_stream(c, 16, short_len=2, query_pool=4)
        s = AsyncRetrievalScheduler(streamed, twolevel.fast(),
                                    SchedulerConfig(max_batch=4, pad_terms=4),
                                    routing=policy, device="cpu")
        hs = [s.submit(r) for r in stream]
        s.flush()
        assert all(h.result().ids.shape[0] == 1 for h in hs)
        assert set(s.stats()["requests_by_route"]) == {"short", "long"}
        pool = AsyncRetrievalScheduler(
            streamed, twolevel.fast(),
            SchedulerConfig(max_batch=4, pad_terms=4, executors=2),
            routing=policy, device="cpu")
        with pool:
            res = run_workload(pool, stream, qps=2000.0)
        assert res["n"] == 16 and res["completed"] == 16
        assert sum(res["batches_by_executor"].values()) == res["batches"]

        from repro_torch.core import dense_guided
        from repro_torch.eval import (build_hybrid, evaluate_ranking,
                                      make_graded_corpus)
        g = make_graded_corpus(n_docs=512, n_terms=128, n_queries=4,
                               n_q_terms=4, dim=8, seed=2)
        hyb = build_hybrid(g, tile_size=128, block_size=128, device="cpu")
        for engine in ("cascade", "rrf"):
            resp = Retriever.open(hyb, twolevel.fast(), engine=engine,
                                  first_stage="kernel",
                                  traversal="chunked_fused", depth=50,
                                  device="cpu").search(**g.queries(), k=10)
            assert resp.ids.shape == (4, 10) and (resp.ids >= 0).all()
            quality = evaluate_ranking(resp.ids, g.qrels)
            assert 0.0 <= quality["mrr@10"] <= 1.0
        dense = dense_guided.build_dense_index(g.doc_emb, block_size=128,
                                               d_cheap=4, device="cpu")
        q = np.random.default_rng(0).standard_normal((3, 8))
        resp = Retriever.open(dense, twolevel.fast(), engine="dense",
                              device="cpu").search(dense=q, k=5)
        assert resp.ids.shape == (3, 5) and np.isfinite(resp.scores).all()

        import repro_torch.models, repro_torch.sparse_ops
        from repro_torch.configs import get_arch
        from repro_torch.launch import steps
        for arch_id, shape in (("granite-3-2b", "decode_32k"),
                               ("dlrm-rm2", "serve_p99")):
            arch = get_arch(arch_id)
            cfg = arch.smoke()
            params = steps.init_fn(arch, shape, cfg, device="cpu")(0)
            batch = steps.smoke_batch(arch, shape, cfg, device="cpu")
            out = steps.make_serve_step(arch, shape, cfg)(params,
                                                          *batch.values())
            out = out[0] if isinstance(out, tuple) else out
            assert out.isfinite().all()
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not leaked, leaked
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
