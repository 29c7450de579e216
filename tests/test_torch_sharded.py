"""The port's sharded retrieval (``repro_torch.core.shard_plan``,
``repro_torch.serve.sharded``) against the JAX package's, on the CPU.

``tests/test_sharded.py`` case for case (same names): the shard plan's
invariants, and sharded-vs-single-device parity. Inside the port every
bit-identity the reference pins holds bit for bit (rank-safe sharded ==
the port's own ``retrieve_batched``, chunked == impact-ordered full scan,
the mesh path == the emulation). Against the reference: ids and every
stat (``shard_tiles_visited``, ``chunks_dispatched``, ...) equal the JAX
sharded path's, scores within ``topk_scores_match``. Added: the port's
``shard_index`` equals the reference's leaf for leaf (fp32 and q8), the q8
index shards as the reference's does, and ``shard(s)`` views.

The mesh path runs on a ``torch.distributed`` gloo group: a world of size
1 in this process (the reference's 1-device mesh), and 8 ranks in
subprocesses with ``jax`` and ``repro`` blocked (the reference's
8-fake-device subprocess, ``slow`` as there)."""
import dataclasses
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import topk_scores_match
from torch_ranks import BLOCK_JAX, run_ranks
from repro.core import build_index as jax_build_index
from repro.core import twolevel as jax_twolevel
from repro.core.shard_plan import shard_index as jax_shard_index
from repro.index import compress_index as jax_compress
from repro.serve.sharded import \
    shard_retrieve_batched as jax_shard_retrieve
from repro_torch import bridge
from repro_torch.core import twolevel
from repro_torch.core.shard_plan import ShardedImpactIndex, shard_index
from repro_torch.core.traversal import STAT_KEYS, retrieve_batched
from repro_torch.index import CompressedImpactIndex, compress_index
from repro_torch.serve.sharded import make_shard_mesh, shard_retrieve_batched

SHARD_STATS = STAT_KEYS + ("n_tiles", "shard_tiles_visited")
CHUNK_STATS = ("chunks_dispatched", "n_chunks", "shard_chunks_dispatched")


def _bridge(jidx):
    return bridge.index_from_arrays(
        {f.name: (None if getattr(jidx, f.name) is None
                  else np.asarray(getattr(jidx, f.name)))
         for f in dataclasses.fields(jidx)}, device="cpu")


@pytest.fixture(scope="module")
def setup(small_corpus):
    jidx = jax_build_index(small_corpus.merged("scaled"), tile_size=256)
    return small_corpus, jidx, _bridge(jidx)   # 2048 docs -> 8 tiles


@pytest.fixture(scope="module")
def q8_setup(small_corpus):
    merged = small_corpus.merged("scaled")
    return (small_corpus, jax_compress(merged, tile_size=256),
            compress_index(merged, tile_size=256, device="cpu"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of world size 1 in this process."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _q(corpus):
    return corpus.queries, corpus.q_weights_b, corpus.q_weights_l


def _jp(p):
    """The reference's TwoLevelParams with the same fields."""
    return jax_twolevel.TwoLevelParams(**{
        f.name: getattr(p, f.name) for f in dataclasses.fields(p)
        if f.name != "k"})


def _same(res, ref):
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_array_equal(res.scores, ref.scores)


def _matches_reference(port, jref, chunked=False):
    """ids and stats equal the JAX sharded path's, scores within
    ``topk_scores_match``."""
    np.testing.assert_array_equal(port.ids, jref.ids)
    topk_scores_match(port.scores, jref.scores)
    keys = SHARD_STATS + (CHUNK_STATS if chunked else ())
    for key in keys:
        np.testing.assert_array_equal(port.stats[key],
                                      np.asarray(jref.stats[key]),
                                      err_msg=key)
    assert set(port.stats) == set(jref.stats)


def _port_leaf(name, a):
    """A reference leaf in the port's device dtype."""
    return {"packed": lambda x: x.view(np.int32),
            "first": lambda x: x.astype(np.int32)}.get(name, lambda x: x)(a)


# -- shard plan construction --------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 16])
def test_shard_plan_repacks_every_posting(setup, n_shards):
    """Per-shard slabs partition the postings: rebasing each shard's local
    docids by its doc_base and re-sorting (term, docid) recovers exactly
    the original flat arrays: nothing lost, duplicated, or re-weighted."""
    corpus, _, index = setup
    sh = shard_index(index, n_shards, device="cpu")
    assert sh.nnz_per_shard.sum() == index.nnz
    assert n_shards * sh.tiles_per_shard >= index.n_tiles
    doc_base = sh.doc_base.numpy()
    ptr = sh.tile_ptr.numpy()
    got = []
    for s in range(n_shards):
        nnz = int(sh.nnz_per_shard[s])
        docs = sh.docids[s][:nnz].numpy() + doc_base[s]
        wb = sh.w_b[s][:nnz].numpy()
        wl = sh.w_l[s][:nnz].numpy()
        # term of each local posting from the local tile_ptr row bounds
        term_of = np.repeat(np.arange(index.n_terms),
                            ptr[s, :, -1] - ptr[s, :, 0])
        got.append(np.stack([term_of, docs, wb, wl]))
    term_of, docs, wb, wl = np.concatenate(got, axis=1)
    order = np.lexsort((docs, term_of))
    np.testing.assert_array_equal(docs[order], index.docids.numpy())
    np.testing.assert_array_equal(wb[order], index.w_b.numpy())
    np.testing.assert_array_equal(wl[order], index.w_l.numpy())


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("kind", ["fp32", "q8"])
def test_shard_plan_equals_reference_leaf_for_leaf(setup, q8_setup, kind,
                                                   n_shards):
    """Every stacked leaf, the maxima, doc bases and real-tile counts of
    the port's shard_index equal the reference's (q8 ``packed`` as its
    int32 bitcast, ``first`` widened to int32)."""
    if kind == "fp32":
        _, jidx, tidx = setup
    else:
        _, jidx, tidx = q8_setup
    ref = jax_shard_index(jidx, n_shards)
    got = shard_index(tidx, n_shards, device="cpu")
    assert got.gather_kind == ref.gather_kind == kind
    for f in ("n_shards", "n_docs", "n_terms", "tile_size", "n_tiles",
              "tiles_per_shard", "pad_len"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_array_equal(got.nnz_per_shard, ref.nnz_per_shard)
    names = (("docids", "w_b", "w_l", "tile_ptr") if kind == "fp32" else
             ("packed", "qb", "ql", "tile_ptr", "pack_ptr", "width", "first",
              "scale_b", "zero_b", "scale_l", "zero_l"))
    assert len(got.gather) == len(ref.gather) == len(names)
    for name, a, b in zip(names, got.gather, ref.gather):
        want = _port_leaf(name, np.asarray(b))
        assert a.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(a.numpy(), want, err_msg=name)
    for f in ("doc_base", "n_real_tiles", "tile_max_b", "tile_max_l",
              "sigma_b", "sigma_l"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for s in range(n_shards):
        assert got.n_real(s) == int(ref.n_real_tiles[s])
        assert got.base(s) == int(ref.doc_base[s])


def test_shard_plan_padded_tiles_are_empty(setup):
    """n_shards that don't divide n_tiles pad the tail shard: padded tiles
    carry zero postings and zero block maxima."""
    _, _, index = setup
    sh = shard_index(index, 3, device="cpu")  # 8 tiles -> tps=3, 2 real + 1
    assert sh.tiles_per_shard == 3
    ptr = sh.tile_ptr[2].numpy()
    assert np.all(ptr[:, -1] == ptr[:, -2])  # pad tile: empty runs
    assert float(sh.tile_max_b[2][:, -1].max()) == 0.0
    assert float(sh.tile_max_l[2][:, -1].max()) == 0.0


@pytest.mark.parametrize("kind", ["fp32", "q8"])
def test_shard_views_slice_the_stack(setup, q8_setup, kind):
    """``shard(s)`` is an ordinary index over the shard's tiles whose
    tensors are views of the stacked ones (no copy), with the global list
    maxima; ``to``, ``device`` and ``nbytes`` cover every tensor."""
    index = setup[2] if kind == "fp32" else q8_setup[2]
    sh = shard_index(index, 3, device="cpu")
    assert isinstance(sh, ShardedImpactIndex) and sh.device.type == "cpu"
    assert sh.to("cpu") is sh
    for s in range(3):
        v = sh.shard(s)
        assert isinstance(v, type(index))
        assert v.gather_kind == kind and v.n_tiles == sh.tiles_per_shard
        assert v.orig_of_new is None and v.sigma_b is sh.sigma_b
        for leaf, stacked in zip(v.gather_arrays(), sh.gather):
            assert leaf.data_ptr() == stacked[s].data_ptr()
        assert v.tile_max_b.data_ptr() == sh.tile_max_b[s].data_ptr()
    if kind == "q8":
        assert isinstance(sh.shard(0), CompressedImpactIndex)
        with pytest.raises(AttributeError, match="fp32"):
            sh.docids
    nb = sh.nbytes()
    assert nb["total"] == (nb["per_shard"] * 3 + nb["replicated"])
    with pytest.raises(IndexError):
        sh.shard(3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            shard_index(index, 2)                      # device="cuda"


# -- parity: emulation path (any shard count on 1 device) ---------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("schedule", ["docid", "impact"])
def test_single_shard_exact_parity_guided(setup, schedule, use_kernel):
    """n_shards=1 is the same traversal: any config matches bit-exactly."""
    corpus, jidx, index = setup
    p = twolevel.fast().replace(schedule=schedule)
    ref = retrieve_batched(index, *_q(corpus), p, use_kernel=use_kernel)
    res = shard_retrieve_batched(shard_index(index, 1, device="cpu"),
                                 *_q(corpus), p, use_kernel=use_kernel)
    _same(res, ref)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, 1), *_q(corpus), _jp(p)))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("schedule", ["docid", "impact"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_multi_shard_rank_safe_exact_parity(setup, n_shards, schedule,
                                            use_kernel):
    """Rank-safe configs: pruning is bound-exact, so tile-range sharding
    (a traversal-order change) must return bit-identical top-k."""
    corpus, jidx, index = setup
    p = twolevel.original(gamma=0.2).replace(schedule=schedule)
    ref = retrieve_batched(index, *_q(corpus), p, use_kernel=use_kernel)
    res = shard_retrieve_batched(shard_index(index, n_shards, device="cpu"),
                                 *_q(corpus), p, use_kernel=use_kernel)
    _same(res, ref)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, n_shards), *_q(corpus), _jp(p)))


@pytest.mark.parametrize("schedule", ["docid", "impact"])
def test_multi_shard_guided_parity(setup, schedule):
    """Guided configs prune against order-dependent thresholds, so shard-
    local thresholds are only *looser* (never unsafe). On this corpus the
    kept sets coincide, pinning the merge end-to-end for unsafe configs."""
    corpus, jidx, index = setup
    p = twolevel.fast().replace(schedule=schedule)
    ref = retrieve_batched(index, *_q(corpus), p)
    res = shard_retrieve_batched(shard_index(index, 4, device="cpu"),
                                 *_q(corpus), p)
    _same(res, ref)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, 4), *_q(corpus), _jp(p)))


def test_multi_shard_guided_scores_dominate(setup):
    """The corpus-robust guided invariant: a shard's local theta trajectory
    is always <= the single-device one (its queue saw a subset of tiles),
    so every doc freezes no earlier and every returned score dominates
    elementwise. threshold_factor=1.5 forces aggressive pruning so the
    trajectories actually diverge."""
    corpus, jidx, index = setup
    p = twolevel.fast().replace(threshold_factor=1.5)
    ref = retrieve_batched(index, *_q(corpus), p)
    res = shard_retrieve_batched(shard_index(index, 4, device="cpu"),
                                 *_q(corpus), p)
    assert np.all(res.scores >= ref.scores - 1e-5)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, 4), *_q(corpus), _jp(p)))


def test_threshold_exchange_rank_safe_exact(setup):
    """The exchanged floor is the exact global theta (a safe bound), so
    rank-safe results stay bit-identical at any exchange period."""
    corpus, jidx, index = setup
    p = twolevel.original(gamma=0.2)
    ref = retrieve_batched(index, *_q(corpus), p)
    sh = shard_index(index, 4, device="cpu")
    jsh = jax_shard_index(jidx, 4)
    for every in (1, 2):
        res = shard_retrieve_batched(sh, *_q(corpus), p,
                                     exchange_every=every)
        _same(res, ref)
        _matches_reference(res, jax_shard_retrieve(
            jsh, *_q(corpus), _jp(p), exchange_every=every))


def test_fine_exchange_beyond_former_round_cap(small_corpus):
    """exchange_every=1 at 256 tiles (128 rounds/shard) stays
    bit-identical for rank-safe configs."""
    corpus = small_corpus
    jidx = jax_build_index(corpus.merged("scaled"), tile_size=8)  # 256 tiles
    index = _bridge(jidx)
    p = twolevel.original(gamma=0.2)
    ref = retrieve_batched(index, *_q(corpus), p)
    res = shard_retrieve_batched(shard_index(index, 2, device="cpu"),
                                 *_q(corpus), p, exchange_every=1)
    _same(res, ref)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, 2), *_q(corpus), _jp(p), exchange_every=1))


def test_exchange_round_sentinel_padding_parity(setup):
    """Periods that don't divide tiles_per_shard exercise the sentinel
    tile: it must touch no queue or stat (tiles_visited unchanged)."""
    corpus, jidx, index = setup
    p = twolevel.original(gamma=0.2)
    sh = shard_index(index, 3, device="cpu")  # 8 tiles -> 3 tiles/shard
    jsh = jax_shard_index(jidx, 3)
    ref = retrieve_batched(index, *_q(corpus), p)
    for every in (2, 4):  # 2: padded tail round; 4 > tps: single round
        res = shard_retrieve_batched(sh, *_q(corpus), p,
                                     exchange_every=every)
        _same(res, ref)
        np.testing.assert_allclose(res.stats["shard_tiles_visited"].sum(1),
                                   res.stats["tiles_visited"])
        _matches_reference(res, jax_shard_retrieve(
            jsh, *_q(corpus), _jp(p), exchange_every=every))


def test_one_device_mesh_equals_emulation(setup, world1):
    """The collective path on a gloo group of one rank == the emulation."""
    corpus, _, index = setup
    p = twolevel.fast()
    sh = shard_index(index, 1, device="cpu")
    emu = shard_retrieve_batched(sh, *_q(corpus), p)
    msh = shard_retrieve_batched(sh, *_q(corpus), p, mesh=make_shard_mesh(1))
    _same(msh, emu)
    for key in SHARD_STATS:
        np.testing.assert_array_equal(msh.stats[key], emu.stats[key])


# -- chunked per-shard traversal ----------------------------------------------

@pytest.mark.parametrize("exchange_every", [0, 2])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_chunked_bit_identical_to_full_impact(setup, n_shards,
                                                      exchange_every):
    """Per-shard chunk loops visit each shard's tiles in descending-bound
    order: bit-identical to the impact-schedule full sharded scan (ids,
    scores, tiles_visited), shape-padding tiles included (n_shards=3 pads
    the tail shard). chunks_dispatched never exceeds the chunk grid."""
    corpus, jidx, index = setup
    p = twolevel.fast().replace(chunk_tiles=2)
    sh = shard_index(index, n_shards, device="cpu")
    full = shard_retrieve_batched(sh, *_q(corpus),
                                  p.replace(schedule="impact"),
                                  exchange_every=exchange_every)
    ck = shard_retrieve_batched(sh, *_q(corpus), p, traversal="chunked",
                                exchange_every=exchange_every)
    _same(full, ck)
    np.testing.assert_array_equal(full.stats["tiles_visited"],
                                  ck.stats["tiles_visited"])
    assert (ck.stats["chunks_dispatched"] <= ck.stats["n_chunks"]).all()
    assert ck.stats["shard_chunks_dispatched"].shape == (
        len(corpus.queries), n_shards)
    np.testing.assert_allclose(ck.stats["shard_chunks_dispatched"].sum(1),
                               ck.stats["chunks_dispatched"])
    _matches_reference(ck, jax_shard_retrieve(
        jax_shard_index(jidx, n_shards), *_q(corpus), _jp(p),
        traversal="chunked", exchange_every=exchange_every), chunked=True)


def test_sharded_chunked_mesh_equals_emulation(setup, world1):
    """The chunk loop on the collective path == the emulation path
    (including the chunks_dispatched counters)."""
    corpus, _, index = setup
    p = twolevel.fast().replace(chunk_tiles=2)
    sh = shard_index(index, 1, device="cpu")
    emu = shard_retrieve_batched(sh, *_q(corpus), p, traversal="chunked",
                                 exchange_every=2)
    msh = shard_retrieve_batched(sh, *_q(corpus), p, traversal="chunked",
                                 exchange_every=2, mesh=make_shard_mesh(1))
    _same(msh, emu)
    for key in SHARD_STATS + CHUNK_STATS:
        np.testing.assert_array_equal(msh.stats[key], emu.stats[key])


def test_sharded_chunked_rejects_unknown_traversal(setup):
    corpus, _, index = setup
    with pytest.raises(ValueError, match="traversal"):
        shard_retrieve_batched(shard_index(index, 2, device="cpu"),
                               *_q(corpus), twolevel.fast(),
                               traversal="fused")


def test_mesh_shard_count_mismatch_raises(setup, world1):
    corpus, _, index = setup
    with pytest.raises(ValueError, match="shards"):
        shard_retrieve_batched(shard_index(index, 2, device="cpu"),
                               *_q(corpus), twolevel.fast(),
                               mesh=make_shard_mesh(1))
    with pytest.raises(ValueError, match="ranks"):
        make_shard_mesh(2)


def test_sharded_stats_consistent(setup):
    corpus, _, index = setup
    res = shard_retrieve_batched(shard_index(index, 4, device="cpu"),
                                 *_q(corpus), twolevel.fast())
    s = res.stats
    assert np.all(s["docs_survived"] <= s["docs_present"])
    assert np.all(s["docs_frozen"] <= s["docs_survived"])
    assert np.all(s["tiles_visited"] <= s["n_tiles"])
    assert s["shard_tiles_visited"].shape == (len(corpus.queries), 4)
    np.testing.assert_allclose(s["shard_tiles_visited"].sum(1),
                               s["tiles_visited"])


def test_sharded_server_matches_plain_server(setup):
    """ShardedRetrievalServer serves the same results through the queue/
    batch machinery as the single-device server."""
    from repro_torch.serve import (Request, RetrievalServer, ServerConfig,
                                   ShardedRetrievalServer)
    corpus, _, index = setup
    params = twolevel.fast()
    cfg = ServerConfig(max_batch=4)
    with pytest.warns(DeprecationWarning):
        plain = RetrievalServer(index, params, cfg, device="cpu")
        sharded = ShardedRetrievalServer(index, params, cfg, n_shards=3,
                                         device="cpu")
    assert sharded.sharded.n_shards == 3

    def reqs():
        return [Request(corpus.queries[i], corpus.q_weights_b[i],
                        corpus.q_weights_l[i]) for i in range(6)]

    for srv in (plain, sharded):
        for r in reqs():
            srv.submit(r, 0.0)
        while srv.pending:
            srv._flush()
    assert len(plain.completed) == len(sharded.completed) == 6
    for a, b in zip(plain.completed, sharded.completed):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


# -- the q8 index -------------------------------------------------------------

@pytest.mark.parametrize("traversal,use_kernel,exchange_every", [
    ("full", False, 0), ("full", True, 2), ("chunked", True, 0),
    ("chunked", False, 2)])
def test_q8_sharded_matches_reference(q8_setup, traversal, use_kernel,
                                      exchange_every):
    """The q8 index sharded (decoded in the gather, or in
    ``guided_score_tile_q``'s plain version): guided results match the
    JAX q8 sharded path's; rank-safe ones equal the port's single-device
    q8 search bit for bit."""
    corpus, jidx, index = q8_setup
    sh = shard_index(index, 3, device="cpu")
    kw = dict(use_kernel=use_kernel, exchange_every=exchange_every,
              traversal=traversal)
    p = twolevel.fast().replace(chunk_tiles=2)
    res = shard_retrieve_batched(sh, *_q(corpus), p, **kw)
    _matches_reference(res, jax_shard_retrieve(
        jax_shard_index(jidx, 3), *_q(corpus), _jp(p), **kw),
        chunked=traversal == "chunked")
    safe = twolevel.original(gamma=0.2)
    _same(shard_retrieve_batched(sh, *_q(corpus), safe, **kw),
          retrieve_batched(index, *_q(corpus), safe, use_kernel=use_kernel))


# -- the collective path on 8 ranks -------------------------------------------

_MESH_PARITY_SCRIPT = BLOCK_JAX + textwrap.dedent("""
    import json
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import build_index, twolevel
    from repro_torch.core.shard_plan import shard_index
    from repro_torch.core.traversal import retrieve_batched
    from repro_torch.data import make_corpus
    from repro_torch.serve.sharded import (make_shard_mesh,
                                           shard_retrieve_batched)

    rank, store = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=8)
    c = make_corpus("splade_like", n_docs=2048, n_terms=512, n_queries=12,
                    n_q_terms=5, n_rel=3, avg_doc_terms=24, seed=7)
    index = build_index(c.merged("scaled"), tile_size=256, device="cpu")
    q = (c.queries, c.q_weights_b, c.q_weights_l)
    sh = shard_index(index, 8, device="cpu")
    mesh = make_shard_mesh(8)
    out = {}

    def eq(a, b):
        return bool(np.array_equal(a.ids, b.ids)
                    and np.array_equal(a.scores, b.scores)
                    and all(np.array_equal(a.stats[k], b.stats[k])
                            for k in b.stats))

    def ids_eq(a, b):
        return bool(np.array_equal(a.ids, b.ids)
                    and np.array_equal(a.scores, b.scores))

    # rank-safe: collective path bit-identical to single device
    p = twolevel.original(gamma=0.2)
    ref = retrieve_batched(index, *q, p)
    out["safe_docid"] = ids_eq(shard_retrieve_batched(sh, *q, p, mesh=mesh),
                               ref)
    pi = p.replace(schedule="impact")
    out["safe_impact"] = ids_eq(
        shard_retrieve_batched(sh, *q, pi, mesh=mesh),
        retrieve_batched(index, *q, pi))
    # guided: mesh path == emulation path (same math, collective merge)
    pf = twolevel.fast()
    out["guided_mesh_eq_emu"] = eq(
        shard_retrieve_batched(sh, *q, pf, mesh=mesh),
        shard_retrieve_batched(sh, *q, pf))
    # threshold exchange stays exact for rank-safe configs
    out["exchange"] = ids_eq(
        shard_retrieve_batched(sh, *q, p, mesh=mesh, exchange_every=1), ref)
    # the kernel's scorer (its plain version on CPU tensors) on the mesh
    out["kernel"] = ids_eq(
        shard_retrieve_batched(sh, *q, p, mesh=mesh, use_kernel=True), ref)
    # chunked loop on the mesh == full impact scan per shard, and == the
    # emulation (dispatch counters included), with exchange
    pc = pf.replace(chunk_tiles=2)
    ck = shard_retrieve_batched(sh, *q, pc, mesh=mesh, traversal="chunked",
                                exchange_every=2)
    out["chunked"] = ids_eq(ck, shard_retrieve_batched(
        sh, *q, pc.replace(schedule="impact"), mesh=mesh, exchange_every=2))
    out["chunked_mesh_eq_emu"] = eq(ck, shard_retrieve_batched(
        sh, *q, pc, traversal="chunked", exchange_every=2))
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    out["no_jax"] = not leaked
    dist.destroy_process_group()
    print("RESULT:" + json.dumps(out))
""")


@pytest.mark.slow
def test_sharded_mesh_parity_multi_device_subprocess(tmp_path):
    """8 gloo ranks, one shard each, with jax and repro blocked: the
    reference's six checks (rank-safe docid/impact == single device,
    guided mesh == emulation, exchange, the kernel scorer, chunked ==
    impact full scan), plus chunked mesh == emulation with exchange.
    Every rank returns the same answers."""
    outs = run_ranks(_MESH_PARITY_SCRIPT, 8, tmp_path)
    assert all(o == outs[0] for o in outs)
    assert all(outs[0].values()), outs[0]
