"""The port's CUDA kernels on the card, against their plain versions, and
searches and model serve steps on the card against the same on the CPU.

Marked ``cuda``: without a CUDA device every test skips (the decision is
made in the ``cuda`` fixture, at run time). This file imports neither JAX
nor the reference package, so it also runs where only the port's
dependencies exist:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_index, twolevel
from repro_torch.data import make_corpus
from repro_torch.index import (compress_index, encode_runs,
                               from_encoded_grids, gather_tile_q_raw)
from repro_torch.configs import get_arch
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import guided_score as gs
from repro_torch.launch import steps
from repro_torch.retrieval import Retriever
from repro_torch.serve import (AsyncRetrievalScheduler, RoutingPolicy,
                               SchedulerConfig, mixed_request_stream, route,
                               table8_policy)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products
    return torch.device("cuda")


def _inputs(rng, lead, nq, p, tile_size, full_every=0):
    """Runs of a random length up to min(P, S); with ``full_every``, every
    such run (counted over rows and terms) holds min(P, S) postings."""
    n = int(np.prod(lead))
    offs = np.full((n, nq, p), -1, np.int32)
    for r in range(n):
        for i in range(nq):
            cnt = int(rng.integers(0, min(p, tile_size) + 1))
            if full_every and (r * nq + i) % full_every == 0:
                cnt = min(p, tile_size)
            offs[r, i, :cnt] = np.sort(rng.choice(tile_size, cnt,
                                                  replace=False))
    wb = (rng.random(offs.shape) * 3).astype(np.float32) * (offs >= 0)
    wl = (rng.random(offs.shape) * 5).astype(np.float32) * (offs >= 0)
    ess = (rng.random((n, nq)) < 0.5).astype(np.float32)
    pb = np.cumsum(rng.random((n, nq)), -1).astype(np.float32)
    shapes = (lead + (nq, p),) * 3 + (lead + (nq,),) * 2
    return [torch.from_numpy(a).reshape(s)
            for a, s in zip((offs, wb, wl, ess, pb), shapes)]


# b, c, nq, p, s, full_every. After the first four, the tile kernels'
# edges: two presence-mask words (Nq 33, 64), runs longer than 32 postings
# that cross lane blocks, S not a multiple of the lane width or below it,
# and runs of exactly P (P = S: every slot; P = 40 over 2048 slots). The
# last six are chunks large enough for a wider chunk lane width
# (``chunk_lane_width``: 512, or 256 at Nq 64): mixed skips over tiles of
# several lane blocks, Nq 33 and 64, S not a multiple of it, runs of
# exactly P = 96 and 2048 (longer than 64 postings), and S = 384 below it.
KERNEL_CASES = [
    (3, 4, 5, 96, 384, 0), (2, 3, 16, 2048, 2048, 0),
    (2, 2, 64, 128, 1024, 0), (4, 2, 7, 300, 1000, 0),
    (2, 2, 33, 200, 2000, 0), (3, 2, 64, 512, 1500, 0),
    (2, 2, 16, 2048, 2048, 3), (2, 2, 64, 40, 2048, 4),
    (2, 1, 5, 40, 100, 0),
    (9, 8, 16, 64, 2048, 0), (9, 8, 33, 200, 2000, 0),
    (9, 8, 64, 512, 1500, 0), (9, 8, 16, 96, 2048, 2),
    (9, 8, 16, 2048, 2048, 3), (24, 12, 16, 96, 384, 0)]


@pytest.mark.parametrize(
    "b,c,nq,p,s,full_every", KERNEL_CASES,
    ids=["-".join(map(str, case[:5])) + (f"-full{case[5]}" if case[5] else "")
         for case in KERNEL_CASES])
def test_kernels_equal_plain_on_card(cuda, b, c, nq, p, s, full_every):
    """Masks identical and scores bit-equal: the kernel rounds every
    product and sum as the plain version does (no contracted FMAs)."""
    rng = np.random.default_rng(b * 100 + nq)
    offs, wb, wl, ess, pb = (t.to(cuda) for t in _inputs(
        rng, (b, c), nq, p, s, full_every))
    if full_every:
        assert bool(((offs >= 0).sum(-1) == p).any())
    skip = torch.from_numpy((rng.random((b, c)) < 0.4).astype(np.int32)).to(
        cuda)
    th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(cuda)
    args = (offs, wb, wl, ess, pb, skip, th, 0.7, 0.2, 0.05)
    torch.testing.assert_close(gs.guided_score_chunk(*args, tile_size=s),
                               gs.guided_score_chunk_plain(*args,
                                                           tile_size=s),
                               rtol=0, atol=0)
    targs = (offs[:, 0].contiguous(), wb[:, 0].contiguous(),
             wl[:, 0].contiguous(), ess[:, 0].contiguous(),
             pb[:, 0].contiguous(), th, 1.0, 0.3, 0.05)
    torch.testing.assert_close(gs.guided_score_tile(*targs, tile_size=s),
                               gs.guided_score_tile_plain(*targs,
                                                          tile_size=s),
                               rtol=0, atol=0)
    torch.cuda.synchronize()


def test_wrappers_validate_and_count(cuda):
    rng = np.random.default_rng(0)
    offs, wb, wl, ess, pb = (t.to(cuda) for t in _inputs(rng, (2,), 4, 32,
                                                          256))
    th = torch.zeros(2, device=cuda)
    gs.reset_launches()
    gs.guided_score_tile(offs, wb, wl, ess, pb, th, 1.0, 0.3, 0.05,
                         tile_size=256)
    assert gs.guided_score_tile.launches == 1
    assert gs.guided_score_chunk.launches == 0
    with pytest.raises(ValueError, match="wb"):
        gs.guided_score_tile(offs, wb.double(), wl, ess, pb, th, 1.0, 0.3,
                             0.05, tile_size=256)
    with pytest.raises(ValueError, match="contiguous"):
        gs.guided_score_tile(offs, wb, wl.transpose(1, 2).contiguous()
                             .transpose(1, 2), ess, pb, th, 1.0, 0.3, 0.05,
                             tile_size=256)
    with pytest.raises(ValueError, match="th_lo"):
        gs.guided_score_tile(offs, wb, wl, ess, pb, th.cpu(), 1.0, 0.3,
                             0.05, tile_size=256)
    assert gs.guided_score_tile.launches == 1


def test_search_on_card_matches_cpu(cuda):
    corpus = make_corpus("splade_like", n_docs=8192, n_terms=2048,
                         n_queries=16, n_q_terms=8, avg_doc_terms=24, seed=2)
    merged = corpus.merged("scaled")
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l)
    gpu = build_index(merged, tile_size=512)            # device="cuda"
    cpu = build_index(merged, tile_size=512, device="cpu")
    for traversal in ("chunked_fused", "chunked"):
        gs.reset_launches()
        on_card = Retriever.open(gpu, twolevel.fast(), engine="kernel",
                                 traversal=traversal).search(**q, k=10)
        launched = gs.guided_score_chunk.launches + \
            gs.guided_score_tile.launches
        assert launched > 0
        on_cpu = Retriever.open(cpu, twolevel.fast(), engine="kernel",
                                traversal=traversal,
                                device="cpu").search(**q, k=10)
        np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                                   rtol=1e-6)
        for key in ("tiles_visited", "docs_survived", "chunks_dispatched"):
            np.testing.assert_array_equal(on_card.stats[key],
                                          on_cpu.stats[key])


# gap width -> the least encoded value (gap - 1) that needs it
WIDTH_MIN = {1: 1, 2: 2, 4: 4, 8: 16, 16: 256}


def _q8_rows(rng, lead, nq, p, s, tile=0):
    """Raw q8 rows [*lead, ...] of real encoded runs (``encode_runs``, one
    term per (row, term) of a one-tile index of S >= 384 docs), fetched by
    ``gather_tile_q_raw`` at ``pad_len = p``. Run r has gap width
    ``list(WIDTH_MIN)[r % 5]`` (its first gap sets it, the others are no
    larger); the first three runs hold 0, 1 and min(P, S) postings. Past a
    run's end the rows hold the next run's words and codes, as on the main
    path. ``tile=1`` fetches the sentinel past the index's one tile."""
    n = int(np.prod(lead)) * nq
    locs = []
    for r in range(n):
        lo = list(WIDTH_MIN.values())[r % len(WIDTH_MIN)]
        gaps = rng.integers(0, lo + 1, size=p) + 1
        gaps[0] = lo + 1
        loc = int(rng.integers(0, s // 8)) + np.concatenate(
            [[0], np.cumsum(gaps)])
        loc = loc[loc < s][:int(rng.integers(2, p + 1))]
        if r < 3:
            loc = np.arange(min(p, s))[:(0, 1, p)[r]]
        locs.append(loc)
    cnt = np.array([len(x) for x in locs], np.int64)
    run_of = np.repeat(np.arange(n), cnt)
    w_b = (rng.random(cnt.sum()) * 3).astype(np.float32)
    w_l = (rng.random(cnt.sum()) * 5).astype(np.float32)
    enc = encode_runs(np.concatenate(locs), w_b, w_l, run_of, cnt)
    tmax = [np.zeros((n, 1), np.float32) for _ in range(2)]
    for tm, w in zip(tmax, (w_b, w_l)):
        np.maximum.at(tm[:, 0], run_of, w)
    index = from_encoded_grids(
        s, n, s, cnt[:, None], enc["words"][:, None], enc["packed"],
        enc["qb"], enc["ql"], enc["width"], enc["first"], enc["scale_b"],
        enc["zero_b"], enc["scale_l"], enc["zero_l"], *tmax,
        device="cpu")
    terms = torch.arange(n, dtype=torch.int32).reshape(lead + (nq,))
    return gather_tile_q_raw(index.gather_arrays(), terms,
                             torch.full(lead, tile, dtype=torch.int32),
                             pad_len=p)


@pytest.mark.parametrize("b,c,nq,p,s", [
    (3, 4, 5, 96, 384), (2, 3, 16, 2048, 2048), (2, 2, 64, 128, 1024),
    (4, 2, 7, 300, 1000), (2, 2, 33, 200, 2000), (3, 2, 64, 512, 1500),
    (9, 8, 16, 64, 2048), (9, 8, 33, 200, 2000), (9, 8, 64, 512, 1500),
    (9, 8, 16, 2048, 2048), (24, 12, 16, 96, 384)])
def test_q8_kernels_equal_plain_on_card(cuda, b, c, nq, p, s):
    """Masks and posting counts identical, scores bit-equal, on runs of
    every gap width, empty and full runs and padded terms (qw = 0); cases
    5-6 need two presence-mask words, and their S is not a multiple of the
    tile kernel's lane width. The last five take a wider chunk lane width,
    with each query's C tiles of their own gap widths and zero/scale pairs
    under the query's one pair of weights."""
    rng = np.random.default_rng(b * 100 + nq)
    rows = [t.to(cuda) for t in _q8_rows(rng, (b, c), nq, p, s)]
    assert set(rows[3][..., 2, :].unique().tolist()) == set(WIDTH_MIN)
    qw = rng.random((2, b, nq)).astype(np.float32) * 2
    qw[:, :, -1] = 0.0
    qw_b, qw_l = (torch.from_numpy(a).to(cuda) for a in qw)
    ess = torch.from_numpy((rng.random((b, c, nq)) < 0.5).astype(
        np.float32)).to(cuda)
    pb = torch.from_numpy(np.cumsum(rng.random((b, c, nq)), -1).astype(
        np.float32)).to(cuda)
    skip = torch.from_numpy((rng.random((b, c)) < 0.4).astype(np.int32)).to(
        cuda)
    th = torch.from_numpy(rng.random(b).astype(np.float32) * 3).to(cuda)
    args = (*rows, qw_b, qw_l, ess, pb, skip, th, 0.7, 0.2, 0.05)
    torch.testing.assert_close(gs.guided_score_chunk_q(*args, tile_size=s),
                               gs.guided_score_chunk_q_plain(*args,
                                                             tile_size=s),
                               rtol=0, atol=0)
    targs = (*(t[:, 0].contiguous() for t in rows), qw_b, qw_l,
             ess[:, 0].contiguous(), pb[:, 0].contiguous(), th, 1.0, 0.3,
             0.05)
    torch.testing.assert_close(gs.guided_score_tile_q(*targs, tile_size=s),
                               gs.guided_score_tile_q_plain(*targs,
                                                            tile_size=s),
                               rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("q8", [False, True], ids=["fp32", "q8"])
def test_all_skipped_chunk_is_zero_on_card(cuda, q8):
    """A chunk of the main path's size, [16, 8, 16] tiles of 2048 slots at
    the chunk lane width, with every tile skipped: zero rows, as the plain
    version gives, from the chunk wrapper of each index."""
    rng = np.random.default_rng(11)
    b, c, nq, p, s = 16, 8, 16, 64, 2048
    ess = torch.ones(b, c, nq, device=cuda)
    pb = torch.zeros(b, c, nq, device=cuda)
    skip = torch.ones(b, c, dtype=torch.int32, device=cuda)
    th = torch.zeros(b, device=cuda)
    if q8:
        rows = [t.to(cuda) for t in _q8_rows(rng, (b, c), nq, p, s)]
        qw = tuple(torch.ones(b, nq, device=cuda) for _ in range(2))
        fn, plain = gs.guided_score_chunk_q, gs.guided_score_chunk_q_plain
    else:
        rows = [t.to(cuda) for t in _inputs(rng, (b, c), nq, p, s)[:3]]
        qw = ()
        fn, plain = gs.guided_score_chunk, gs.guided_score_chunk_plain
    args = (*rows, *qw, ess, pb, skip, th, 0.7, 0.2, 0.05)
    gs.reset_launches()
    out = fn(*args, tile_size=s)
    assert fn.launches == 1
    torch.testing.assert_close(out, plain(*args, tile_size=s), rtol=0,
                               atol=0)
    assert not bool(out.any())
    torch.cuda.synchronize()


def test_q8_tile_sentinel_is_zero_on_card(cuda):
    """The chunk schedule's sentinel tile (the id past the last tile: every
    run empty) scores zero rows, as the plain version does."""
    rng = np.random.default_rng(5)
    rows = [t.to(cuda) for t in _q8_rows(rng, (2,), 8, 64, 512, tile=1)]
    assert not bool(rows[3][:, 0].any())                 # cnt = 0
    qw_b, qw_l = (torch.ones(2, 8, device=cuda) for _ in range(2))
    ess = torch.ones(2, 8, device=cuda)
    pb = torch.zeros(2, 8, device=cuda)
    args = (*rows, qw_b, qw_l, ess, pb, torch.zeros(2, device=cuda), 1.0,
            0.3, 0.05)
    out = gs.guided_score_tile_q(*args, tile_size=512)
    torch.testing.assert_close(out, gs.guided_score_tile_q_plain(
        *args, tile_size=512), rtol=0, atol=0)
    assert not bool(out.any())
    torch.cuda.synchronize()


def test_q8_search_on_card_matches_cpu(cuda):
    corpus = make_corpus("splade_like", n_docs=8192, n_terms=2048,
                         n_queries=16, n_q_terms=8, avg_doc_terms=24, seed=2)
    merged = corpus.merged("scaled")
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l)
    gpu = compress_index(merged, tile_size=512)         # device="cuda"
    cpu = compress_index(merged, tile_size=512, device="cpu")
    for traversal, kernel in (("chunked_fused", gs.guided_score_chunk_q),
                              ("chunked", gs.guided_score_tile_q)):
        gs.reset_launches()
        on_card = Retriever.open(gpu, twolevel.fast(), engine="kernel",
                                 traversal=traversal).search(**q, k=10)
        assert kernel.launches > 0
        assert gs.guided_score_chunk.launches == 0
        assert gs.guided_score_tile.launches == 0
        on_cpu = Retriever.open(cpu, twolevel.fast(), engine="kernel",
                                traversal=traversal,
                                device="cpu").search(**q, k=10)
        np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                                   rtol=1e-6)
        for key in ("tiles_visited", "docs_present", "postings_touched",
                    "docs_survived", "chunks_dispatched"):
            np.testing.assert_array_equal(on_card.stats[key],
                                          on_cpu.stats[key])


def test_chunked_search_runs_the_tile_kernels_on_card(cuda):
    """A "chunked" search scores through the tile kernel of its index
    alone: the tile wrapper's count moves, the chunk wrappers' do not."""
    corpus = make_corpus("splade_like", n_docs=4096, n_terms=1024,
                         n_queries=8, n_q_terms=8, avg_doc_terms=16, seed=3)
    merged = corpus.merged("scaled")
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l)
    for index, kernel in ((build_index(merged, tile_size=512),
                           gs.guided_score_tile),
                          (compress_index(merged, tile_size=512),
                           gs.guided_score_tile_q)):
        gs.reset_launches()
        Retriever.open(index, twolevel.fast(), engine="kernel",
                       traversal="chunked").search(**q, k=10)
        counts = {fn.__name__: fn.launches for fn in gs.KERNELS}
        assert counts[kernel.__name__] > 0
        assert sum(counts.values()) == counts[kernel.__name__], counts


def _serving(seed=5):
    """A corpus, its fp32 index on the card, the table-8 policy with K1 on
    the long route, and the scheduler config the serving tests use."""
    corpus = make_corpus("splade_like", n_docs=8192, n_terms=2048,
                         n_queries=16, n_q_terms=8, avg_doc_terms=24,
                         seed=seed)
    index = build_index(corpus.merged("scaled"), tile_size=512)
    policy = table8_policy(long_engine="kernel",
                           long_traversal="chunked_fused")
    cfg = dict(max_batch=8, pad_terms=8, cache_size=0)
    return corpus, index, policy, cfg


def _per_request(retrievers, scheduler, handle, request):
    """``request`` searched alone on its route's Retriever, at the route's
    padded width (zero-weight terms), as the scheduler executes it."""
    rt = scheduler.routing.by_name(handle.route)
    width = rt.pad_terms or scheduler.cfg.pad_terms
    rows = [np.zeros((1, width), dt) for dt in (np.int32, np.float32,
                                                  np.float32)]
    n = len(request.terms)
    for row, src in zip(rows, (request.terms, request.weights_b,
                               request.weights_l)):
        row[0, :n] = src
    return retrievers[handle.route].search(
        terms=rows[0], weights_b=rows[1], weights_l=rows[2], k=request.k)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert set(got.stats) == set(want.stats)
    for key in got.stats:
        np.testing.assert_array_equal(got.stats[key], want.stats[key])


def test_scheduler_on_card_matches_per_request_searches(cuda):
    """The table-8 policy served on the card (short route: the plain
    batched chunked scan; long route: K1, ``chunked_fused``): every handle
    equals a per-request search on its route's Retriever on the card, ids,
    scores and stats; K1 is the only kernel launched, all by the long
    route's batches."""
    corpus, index, policy, cfg = _serving()
    params = twolevel.original(gamma=0.2)
    s = AsyncRetrievalScheduler(index, params, SchedulerConfig(**cfg),
                                routing=policy)
    assert s.device.type == "cuda" and s.index is index
    stream = mixed_request_stream(corpus, 32, short_len=3, k_pool=(10, 100))
    by_route = {}
    for name in ("short", "long"):
        retr = s._retriever(name)
        search = retr.search

        def counted(*a, _search=search, _name=name, **kw):
            before = gs.guided_score_chunk.launches
            out = _search(*a, **kw)
            by_route[_name] = (by_route.get(_name, 0)
                               + gs.guided_score_chunk.launches - before)
            return out
        retr.search = counted
    gs.reset_launches()
    handles = [s.submit(r) for r in stream]
    s.flush()
    counts = {fn.__name__: fn.launches for fn in gs.KERNELS}
    assert counts["guided_score_chunk"] > 0
    assert sum(counts.values()) == counts["guided_score_chunk"], counts
    assert by_route == {"short": 0, "long": counts["guided_score_chunk"]}
    refs = {r.name: Retriever.open(index, params, engine=r.engine,
                                   **r.opts()) for r in policy.routes}
    for h, r in zip(handles, stream):
        _assert_same(h.result(), _per_request(refs, s, h, r))


def test_two_executor_pool_on_card_matches_sync(cuda):
    """Two executors, each on its own CUDA stream, serve a stream bit-equal
    to the synchronous run, and both serve batches; a request whose fields
    are tensors on the card is read to the host at submit and answered as
    its numpy twin."""
    corpus, index, policy, cfg = _serving()
    params = twolevel.original(gamma=0.2)
    stream = mixed_request_stream(corpus, 48, short_len=3, k_pool=(10, 100),
                                  query_pool=12)
    sync = AsyncRetrievalScheduler(index, params, SchedulerConfig(**cfg),
                                   routing=policy)
    hs = [sync.submit(r) for r in stream]
    sync.flush()
    want = [h.result() for h in hs]
    pool = AsyncRetrievalScheduler(
        index, params, SchedulerConfig(**{**cfg, "executors": 2}),
        routing=policy)
    with pool:
        streams = {m.stream for m in pool._pool.replicas.values()}
        assert len(streams) == 2 and None not in streams
        hs = [pool.submit(r) for r in stream]
        got = [h.result(timeout=120) for h in hs]
        twin = stream[1]                     # a long row, k=10
        on_card = pool.submit(
            terms=torch.from_numpy(twin.terms).to(cuda),
            weights_b=torch.from_numpy(twin.weights_b).to(cuda),
            weights_l=torch.from_numpy(twin.weights_l).to(cuda), k=twin.k)
        _assert_same(on_card.result(timeout=120), want[1])
    st = pool.stats()
    assert st["completed"] == len(stream) + 1
    assert len(st["batches_by_executor"]) == 2
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_swap_index_to_q8_on_card_runs_k3(cuda):
    """``swap_index`` from the fp32 index to the q8 index of the same
    corpus, on the card: the long route's batches then launch K3 (and no
    K1), every generation-1 response equals a per-request search on the
    q8 index, and no cache entry survives the swap."""
    corpus, index, policy, cfg = _serving()
    params = twolevel.original(gamma=0.2)
    q8 = compress_index(corpus.merged("scaled"), tile_size=512)
    s = AsyncRetrievalScheduler(index, params,
                                SchedulerConfig(**{**cfg, "cache_size": 64}),
                                routing=policy)
    stream = mixed_request_stream(corpus, 24, short_len=3, k_pool=(10, 100))
    for r in stream:
        s.submit(r)
    s.flush()
    assert s.stats()["cache_entries"] > 0
    assert s.swap_index(q8) == 1 and s.index is q8
    st = s.stats()
    assert st["cache_entries"] == 0 and st["cache_gen_evictions"] > 0
    gs.reset_launches()
    handles = [s.submit(r) for r in stream]
    s.flush()
    assert not any(h.cached for h in handles)
    assert gs.guided_score_chunk_q.launches > 0
    assert gs.guided_score_chunk.launches == 0
    refs = {r.name: Retriever.open(q8, params, engine=r.engine, **r.opts())
            for r in policy.routes}
    for h, r in zip(handles, stream):
        assert h.result().generation == 1
        _assert_same(h.result(), _per_request(refs, s, h, r))


def _sharded_setup(seed=6):
    corpus = make_corpus("splade_like", n_docs=8192, n_terms=2048,
                         n_queries=16, n_q_terms=8, avg_doc_terms=24,
                         seed=seed)
    q = dict(terms=corpus.queries, weights_b=corpus.q_weights_b,
             weights_l=corpus.q_weights_l)
    return corpus, corpus.merged("scaled"), q


@pytest.mark.parametrize("kind", ["fp32", "q8"])
def test_sharded_engine_on_card_matches_cpu(cuda, kind):
    """The sharded engine (3 shards, exchange every 2 tiles) on the card
    against the same search on the CPU, full and chunked: ids, stats and
    the per-shard splits equal, scores within 1e-6; only the index's tile
    kernel launched (K2 on fp32, K4 on q8); rank-safe results equal the
    single-device tile kernel's on the card bit for bit."""
    from repro_torch.core.traversal import retrieve_batched
    _, merged, q = _sharded_setup()
    build = build_index if kind == "fp32" else compress_index
    kernel = gs.guided_score_tile if kind == "fp32" else gs.guided_score_tile_q
    gpu = build(merged, tile_size=512)                  # device="cuda"
    cpu = build(merged, tile_size=512, device="cpu")
    opts = dict(engine="sharded", n_shards=3, use_kernel=True,
                exchange_every=2)
    for traversal in ("full", "chunked"):
        gs.reset_launches()
        r = Retriever.open(gpu, twolevel.fast(), traversal=traversal, **opts)
        assert r.engine.sharded.device.type == "cuda"
        on_card = r.search(**q, k=10)
        counts = {fn.__name__: fn.launches for fn in gs.KERNELS}
        assert counts[kernel.__name__] > 0
        assert sum(counts.values()) == counts[kernel.__name__], counts
        on_cpu = Retriever.open(cpu, twolevel.fast(), traversal=traversal,
                                device="cpu", **opts).search(**q, k=10)
        np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-6)
        assert set(on_card.stats) == set(on_cpu.stats)
        for key in on_card.stats:
            np.testing.assert_array_equal(on_card.stats[key],
                                          on_cpu.stats[key])
    safe = twolevel.original(gamma=0.2)
    for k in (10, 100):
        got = Retriever.open(gpu, safe, **opts).search(**q, k=k)
        want = retrieve_batched(gpu, q["terms"], q["weights_b"],
                                q["weights_l"], safe, use_kernel=True, k=k)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)


def test_sharded_nccl_world_one_equals_emulation(cuda, tmp_path):
    """The collective path on an NCCL group of one rank (a FileStore in a
    temporary directory) equals the emulation path, full and chunked."""
    import torch.distributed as dist
    from repro_torch.core.shard_plan import shard_index
    from repro_torch.serve import make_shard_mesh, shard_retrieve_batched
    _, merged, q = _sharded_setup()
    sh = shard_index(build_index(merged, tile_size=512), 1)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_shard_mesh(1)
        p = twolevel.fast().replace(chunk_tiles=4)
        for traversal in ("full", "chunked"):
            kw = dict(use_kernel=True, traversal=traversal,
                      exchange_every=4)
            emu = shard_retrieve_batched(sh, *q.values(), p, **kw)
            msh = shard_retrieve_batched(sh, *q.values(), p, mesh=mesh, **kw)
            _assert_same(msh, emu)
    finally:
        dist.destroy_process_group()


def test_two_executor_pool_serves_a_sharded_route_on_card(cuda):
    """A 2-executor pool serves a sharded route (K2, 4 shards) on the
    card: every replica shares one partition of the index, and the
    responses equal the synchronous scheduler's."""
    corpus, merged, _ = _sharded_setup()
    index = build_index(merged, tile_size=512)
    policy = RoutingPolicy((
        route("short", 4, "batched", pad_terms=4, traversal="chunked",
              chunk_tiles=2),
        route("long", None, "sharded", n_shards=4, use_kernel=True,
              traversal="chunked")))
    params = twolevel.original(gamma=0.2)
    cfg = dict(max_batch=8, pad_terms=8, cache_size=0)
    stream = mixed_request_stream(corpus, 32, short_len=3, k_pool=(10, 100),
                                  query_pool=8)
    sync = AsyncRetrievalScheduler(index, params, SchedulerConfig(**cfg),
                                   routing=policy)
    hs = [sync.submit(r) for r in stream]
    sync.flush()
    want = [h.result() for h in hs]
    pool = AsyncRetrievalScheduler(
        index, params, SchedulerConfig(**{**cfg, "executors": 2}),
        routing=policy)
    gs.reset_launches()
    with pool:
        got = [pool.submit(r).result(timeout=300) for r in stream]
        part = pool._retriever("long").engine.sharded
        reps = [m["long"] for m in pool._pool.replicas.values()]
        assert len(reps) == 2
        assert all(r.engine.sharded is part for r in reps)
        assert part.device.type == "cuda" and part.n_shards == 4
    assert gs.guided_score_tile.launches > 0
    for a, b in zip(got, want):
        _assert_same(a, b)


# dense, cascade and rrf on the card: scores within topk_scores_match's
# tolerance of the CPU's (the dense products reduce in another order there)
SCORE_RTOL, SCORE_ATOL = 2e-5, 1e-4


def _graded(seed=8):
    from repro_torch.eval import make_graded_corpus
    return make_graded_corpus(n_docs=8192, n_terms=2048, n_queries=16,
                              n_q_terms=8, dim=64, seed=seed)


def _launches():
    return {fn.__name__: fn.launches for fn in gs.KERNELS}


def test_dense_engine_on_card_matches_cpu(cuda):
    """The guided dense scan on the card against the same index moved to
    the CPU: rank-safe ids equal, guided scores within topk_scores_match's
    tolerance, ``candidates_fully_scored`` close; no guided_score kernel
    runs on the dense path."""
    from repro_torch.core.dense_guided import build_dense_index
    g = _graded()
    gpu = build_dense_index(g.doc_emb, block_size=1024, d_cheap=16)
    cpu = gpu.to("cpu")
    q = np.random.default_rng(0).standard_normal((16, 64)).astype(
        np.float32)
    for params in (twolevel.TwoLevelParams(alpha=0, beta=0, gamma=0),
                   twolevel.TwoLevelParams(alpha=1, beta=0.3, gamma=0)):
        gs.reset_launches()
        on_card = Retriever.open(gpu, params, engine="dense").search(
            dense=q, k=10)
        assert sum(_launches().values()) == 0
        on_cpu = Retriever.open(cpu, params, engine="dense",
                                device="cpu").search(dense=q, k=10)
        if params.alpha == 0:
            np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        np.testing.assert_allclose(
            on_card.stats["candidates_fully_scored"],
            on_cpu.stats["candidates_fully_scored"], atol=16)


@pytest.mark.parametrize("kind,engine", [("fp32", "cascade"),
                                         ("q8", "rrf")])
def test_hybrid_engine_on_card_runs_its_chunk_kernel(cuda, kind, engine):
    """Cascade on the fp32 hybrid index runs K1 (``guided_score_chunk``),
    rrf on the q8 one K3 (``guided_score_chunk_q``), and no other kernel;
    ids equal the same search on the index moved to the CPU, scores within
    topk_scores_match's tolerance."""
    from repro_torch.eval import build_hybrid
    g = _graded()
    sparse = (build_index if kind == "fp32" else compress_index)(
        g.corpus.merged("scaled"), tile_size=512)
    hybrid = build_hybrid(g, sparse_index=sparse)
    kernel = ("guided_score_chunk" if kind == "fp32"
              else "guided_score_chunk_q")
    opts = dict(engine=engine, first_stage="kernel",
                traversal="chunked_fused", depth=100)
    q = g.queries()
    for k in (10, 100):
        gs.reset_launches()
        on_card = Retriever.open(hybrid, twolevel.fast(), **opts).search(
            **q, k=k)
        counts = _launches()
        assert counts[kernel] > 0
        assert sum(counts.values()) == counts[kernel], counts
        on_cpu = Retriever.open(hybrid.to("cpu"), twolevel.fast(),
                                device="cpu", **opts).search(**q, k=k)
        np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
        np.testing.assert_allclose(on_card.scores, on_cpu.scores,
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        for key in ("tiles_visited", "chunks_dispatched"):
            np.testing.assert_array_equal(on_card.stats[key],
                                          on_cpu.stats[key])


def test_scheduler_routes_cascade_on_card(cuda):
    """A scheduler route to ``cascade`` (K1 first stage) on the card: every
    handle equals a direct ``Retriever`` search of its request at the
    route's padded width: ids and stats equal, scores within
    topk_scores_match's tolerance (the rerank's product on the card reduces
    in another order for a batch of 8 rows than for one, so scores near 0
    differ in their last bits); K1 alone launched."""
    from repro_torch.eval import build_hybrid
    from repro_torch.serve import single_route
    g = _graded(seed=9)
    hybrid = build_hybrid(g, tile_size=512)
    policy = single_route("cascade", first_stage="kernel",
                          traversal="chunked_fused", depth=100)
    params = twolevel.original(gamma=0.2)
    s = AsyncRetrievalScheduler(hybrid, params,
                                SchedulerConfig(max_batch=8, pad_terms=8,
                                                cache_size=0),
                                routing=policy)
    assert s.index is hybrid
    stream = mixed_request_stream(g.corpus, 24, short_len=3,
                                  k_pool=(10, 100))
    gs.reset_launches()
    handles = [s.submit(r) for r in stream]
    s.flush()
    counts = _launches()
    assert counts["guided_score_chunk"] > 0
    assert sum(counts.values()) == counts["guided_score_chunk"], counts
    refs = {"all": Retriever.open(hybrid, params, engine="cascade",
                                  **policy.routes[0].opts())}
    for h, r in zip(handles, stream):
        got, want = h.result(), _per_request(refs, s, h, r)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_allclose(got.scores, want.scores,
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        assert set(got.stats) == set(want.stats)
        for key in got.stats:
            np.testing.assert_array_equal(got.stats[key], want.stats[key])


# b, h, hkv, sq, skv, d, causal, kv_offset, and the route of a bfloat16
# call (float32 always takes "f32")
FA_CASES = [
    (2, 8, 2, 100, 100, 64, True, 0, "mma"),      # ragged edge, GQA 4
    (1, 4, 4, 1, 300, 128, True, 250, "split"),   # decode row, group 1
    (3, 8, 1, 1, 77, 32, True, 76, "split"),      # decode, MQA (group 8)
    (2, 2, 2, 200, 200, 32, False, 0, "mma"),     # bidirectional (BERT4Rec)
    (1, 4, 2, 70, 130, 24, True, 40, "mma"),      # head dim 24, offset
    (1, 2, 2, 5, 3, 64, True, 10, "split"),       # rows past a short cache
    # the "split" cases of chip_smoke.py's sweep
    (4, 32, 8, 1, 4128, 64, True, 4097, "split"),  # the LM decode step
    (2, 8, 8, 2, 700, 32, True, 600, "split"),    # group 1, D 32, Sq 2
    (1, 16, 4, 3, 1500, 48, True, 1400, "split"),  # group 4, D 48, Sq 3
    (2, 16, 2, 2, 2000, 128, True, 1900, "split"),  # group 8, D 128, 16 rows
    (4, 32, 8, 1, 4128, 64, True, 4096, "split"),  # last split of one key
    (2, 8, 2, 4, 700, 64, True, 640, "split"),    # offset on a split edge
    (1, 4, 4, 1, 333, 64, False, 0, "split"),     # bidirectional
    (1, 1, 1, 17, 300, 64, True, 200, "mma"),     # 17 rows
    # the "mma" odd shapes of chip_smoke.py's sweep
    (1, 8, 1, 70, 300, 48, True, 230, "mma"),     # group 8, D 48 (padded)
    (2, 4, 4, 130, 190, 128, True, 60, "mma"),    # group 1, D 128, offset
    (1, 4, 4, 200, 150, 32, True, 0, "mma"),      # Sq > Skv
    (1, 16, 2, 333, 333, 64, False, 0, "mma"),    # group 8, bidirectional
    (1, 4, 1, 16, 1000, 64, True, 984, "mma"),    # 64 rows over a long cache
    (1, 8, 8, 64, 64, 128, True, 0, "mma"),       # one full block
]


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,off,way", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_close_to_plain_on_card(cuda, b, h, hkv, sq, skv, d,
                                                causal, off, way, dtype):
    """Within ``fa.tolerance`` of the plain version, through the route's
    kernel (its counter moves, the other's does not); a zeroed output
    fails that bound. "f32" also lies within ``fa.three_pass_bound``."""
    g = torch.Generator(device=cuda).manual_seed(sq + skv)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=causal, kv_offset=off)
    if dtype == torch.float32:
        way = "f32"
    assert fa.route(q, k) == way
    before, total = dict(fa.launches_by_route), fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == total + 1
    assert fa.launches_by_route == {**before, way: before[way] + 1}
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_plain(q, k, v, **kw)
    bound = fa.tolerance(q, k, v, ref, way, **kw)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert not bool((ref.float().abs() <= bound).all())   # zeros fail
    if way == "f32":                      # three TF32 passes, not one
        tight = fa.three_pass_bound(ref)
        assert bool((diff <= tight).all()), float((diff - tight).max())
    torch.cuda.synchronize()


def _fa_case(cuda, b, h, hkv, sq, skv, d, dtype, view, seed):
    """q, k, v on the card; with ``view``, [B, S, H, D] tensors read
    through transposed views."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    shapes = ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    if view:
        return [torch.randn((s[0], s[2], s[1], s[3]), generator=g,
                            device=cuda).to(dtype).transpose(1, 2)
                for s in shapes]
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in shapes]


def _fa_on_route(q, k, v, way, kw):
    """One call through ``way`` (its counter alone moves), within the
    route's bound of the plain version, where a zeroed output fails."""
    assert fa.route(q, k) == way
    before = dict(fa.launches_by_route)
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.launches_by_route == {**before, way: before[way] + 1}
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = fa.flash_attention_plain(q, k, v, **kw)
    bound = fa.tolerance(q, k, v, ref, way, **kw)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert not bool((ref.float().abs() <= bound).all())   # zeros fail
    if way == "f32":                      # three TF32 passes, not one
        tight = fa.three_pass_bound(ref)
        assert bool((diff <= tight).all()), float((diff - tight).max())
    torch.cuda.synchronize()
    return out


# float32 edges of the "f32" route: b, h, hkv, sq, skv, d, causal,
# kv_offset, [B, S, H, D] views
F32_CASES = [
    (2, 8, 2, 1, 1500, 64, True, 1499, False),  # decode: 12 tiles, 4 warps
    (1, 8, 2, 1, 300, 64, True, 256, False),    # decode: last tile one key
    (1, 4, 4, 65, 65, 64, True, 0, False),      # prefill: last tile one key
    (2, 8, 2, 100, 100, 32, True, 0, False),    # D 32, GQA 4
    (1, 4, 4, 70, 150, 48, True, 80, False),    # D 48 (padded), group 1
    (1, 8, 8, 3, 500, 128, True, 497, False),   # D 128 decode (16-key slices)
    (2, 4, 2, 130, 190, 128, True, 60, False),  # D 128 prefill (32-key tiles)
    (1, 4, 2, 65, 64, 64, True, 0, False),      # Sq > Skv
    (1, 4, 4, 200, 150, 32, True, 0, False),    # Sq > Skv, several blocks
    (2, 32, 8, 128, 136, 64, True, 0, True),    # lm_f32 prefill, views
    (4, 32, 8, 1, 136, 64, True, 129, True),    # lm_f32 decode, views
    (1, 16, 2, 333, 333, 64, False, 0, False),  # bidirectional, group 8
    (1, 4, 4, 1, 333, 64, False, 0, False),     # bidirectional decode
    (1, 8, 1, 2, 700, 64, True, 600, False),    # group 8, 16 rows: decode
    (1, 1, 1, 17, 300, 64, True, 200, False),   # 17 rows: a partial block
]


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,off,view", F32_CASES)
def test_flash_attention_f32_route_on_card(cuda, b, h, hkv, sq, skv, d,
                                           causal, off, view):
    """Every float32 call takes "f32" (3xTF32 on the tensor cores) and
    lies within 2e-4 + 2e-4 |plain| and within ``fa.three_pass_bound``
    (a tenth of it, which one TF32 pass fails), at decode (the warps split the keys)
    and prefill, through views of [B, S, H, D] tensors."""
    q, k, v = _fa_case(cuda, b, h, hkv, sq, skv, d, torch.float32, view,
                       seed=sq * 7 + skv)
    _fa_on_route(q, k, v, "f32", dict(causal=causal, kv_offset=off))


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,off", [
    (1, 1, 1, 17, 300, 64, 200),      # 17 rows
    (1, 1, 1, 33, 300, 64, 200),      # 33 rows
    (1, 4, 1, 15, 300, 64, 285),      # 60 rows, group 4
    (1, 4, 2, 20, 130, 24, 40),       # D 24, 40 rows
    (2, 8, 2, 5, 600, 40, 500),       # D 40, 20 rows
    (1, 4, 4, 30, 200, 56, 100),      # D 56, 30 rows
])
def test_flash_attention_bf16_above_16_rows_take_mma_on_card(
        cuda, b, h, hkv, sq, skv, d, off):
    """Every bfloat16 call of more than 16 rows per kv head takes "mma",
    which rounds P to bfloat16 as the TPU kernel does, in a partly filled
    block and at a head dim padded 8 at a time: within the mma bound (it
    has the 2^-8 (p @ |v|) term)."""
    q, k, v = _fa_case(cuda, b, h, hkv, sq, skv, d, torch.bfloat16, False,
                       seed=sq + d)
    _fa_on_route(q, k, v, "mma", dict(causal=True, kv_offset=off))


def test_flash_attention_split_reads_cache_views_on_card(cuda):
    """The "split" route reads a [B, max_len, Hkv, D] cache and a [B, 1, H,
    D] query through transposed views, as the decode step passes them:
    equal to the same call on contiguous copies, within the bound; an
    output without the row's last 64-key tile fails it."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 1, 32, 64, generator=g, device=cuda).bfloat16()
    cache = torch.randn(2, 2, 1100, 8, 64, generator=g, device=cuda
                        ).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in (x, cache[0], cache[1]))
    kw = dict(causal=True, kv_offset=1000)
    assert fa.route(q, k) == "split"
    before = fa.launches_by_route["split"]
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.launches_by_route["split"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    same = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              **kw)
    torch.testing.assert_close(out, same, rtol=0, atol=0)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    bound = fa.tolerance(q, k, v, ref, "split", **kw)
    assert bool(((out.float() - ref.float()).abs() <= bound).all())
    cut = fa.flash_attention_plain(q, k[:, :, :960], v[:, :, :960],
                                   causal=False)
    assert not bool(((cut.float() - ref.float()).abs() <= bound).all())
    torch.cuda.synchronize()


def test_flash_attention_reads_transposed_views_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 90, 8, 64, generator=g, device=cuda).bfloat16()
    kv = torch.randn(2, 90, 2, 64, generator=g, device=cuda).bfloat16()
    assert fa.route(x.transpose(1, 2), kv.transpose(1, 2)) == "mma"
    before = fa.launches_by_route["mma"]
    a = fa.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                           kv.transpose(1, 2))
    assert fa.launches_by_route["mma"] == before + 1
    assert a.transpose(1, 2).is_contiguous()          # q's layout kept
    b = fa.flash_attention(x.transpose(1, 2).contiguous(),
                           kv.transpose(1, 2).contiguous(),
                           kv.transpose(1, 2).contiguous())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*(torch.zeros(1, 1, 4, 12, device=cuda)
                             .bfloat16(),) * 3)


@pytest.mark.parametrize("f,v,d,b,l", [
    (1, 1000, 64, 37, 1), (1, 500, 256, 64, 16), (3, 200, 64, 10, 4),
    (26, 300, 64, 40, 1),       # stacked fields, 2 bags per warp (f32)
    (1, 100, 3, 50, 5),         # D 3: the scalar path
    (2, 300, 20, 40, 16),       # D 20: f32 vectors, bf16 scalar
    (1, 64, 1024, 9, 40)])      # row passes, slots past one chunk
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_equal_plain_on_card(cuda, f, v, d, b, l, dtype):
    """Bit-equal: both add in j order, rounding each product and sum to
    the table's dtype; weight-0 padding and out-of-range slots included."""
    g = torch.Generator(device=cuda).manual_seed(f * v + l)
    table = torch.randn(f, v, d, generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, v, (b, f, l), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand(b, f, l, generator=g, device=cuda).to(dtype)
    w[:, :, -1] = 0                                  # padding slots
    idx[0, 0, 0] = v                                 # out of range
    if f == 1:
        table, idx, w = table[0], idx[:, 0].contiguous(), w[:, 0].contiguous()
    torch.testing.assert_close(eb.embedding_bag(table, idx, w),
                               eb.embedding_bag_plain(table, idx, w),
                               rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_scalar_path_on_card(cuda, dtype):
    """A table that starts off a 16-byte boundary takes the scalar path:
    bit-equal, with negative and past-the-end slots adding nothing."""
    g = torch.Generator(device=cuda).manual_seed(5)
    vocab, d = 400, 64
    flat = torch.randn(vocab * d + 1, generator=g, device=cuda).to(dtype)
    table = flat[1:].view(vocab, d)
    assert table.is_contiguous() and table.data_ptr() % 16
    idx = torch.randint(0, vocab, (33, 12), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0, 0], idx[1, 5], idx[2, 11] = -5, vocab, vocab + 7
    w = torch.rand(33, 12, generator=g, device=cuda).to(dtype)
    before = eb.launches
    out = eb.embedding_bag(table, idx, w)
    assert eb.launches == before + 1
    torch.testing.assert_close(out, eb.embedding_bag_plain(table, idx, w),
                               rtol=0, atol=0)
    torch.cuda.synchronize()


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("arch_id,shape", [("granite-3-2b", "decode_32k"),
                                           ("dlrm-rm2", "serve_p99")])
def test_smoke_serve_step_on_card_matches_cpu(cuda, arch_id, shape):
    """A smoke LM decode step (float32 logits within 2e-4) and a smoke
    DLRM serve step (scores within 1e-5) on the card against the same
    step on the CPU, each through its kernel on the card."""
    arch = get_arch(arch_id)
    cfg = arch.smoke()
    params = steps.init_fn(arch, shape, cfg, device="cpu")(0)
    batch = steps.smoke_batch(arch, shape, cfg, device="cpu")
    step = steps.make_serve_step(arch, shape, cfg)
    card_args = (_on(params, cuda), *_on(batch, cuda).values())
    cpu = step(params, *batch.values())
    kern = fa if arch.family == "lm" else eb
    before = kern.launches
    card = step(*card_args)
    assert kern.launches > before
    out_cpu, out_card = (o[0] if isinstance(o, tuple) else o
                         for o in (cpu, card))
    tol = 2e-4 if arch.family == "lm" else 1e-5
    torch.testing.assert_close(out_card.cpu(), out_cpu, rtol=tol, atol=tol)
