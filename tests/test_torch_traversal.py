"""The port's traversal executors against the JAX package's, and the
port's own execution-mode equivalences.

Against the reference (same index arrays via the bridge, same queries):
ids equal (Q_Rk, Q_Gl and Q_Lo), scores within ``topk_scores_match``
(rtol 2e-5, atol 1e-4: XLA contracts the combines into fused
multiply-adds, the port rounds each product), and every stat counter
equal. The configurations form a covering set: on each traversal every
preset, both k, both bound modes (and both schedules on ``full``) appear
at least once; the full product would compile too many interpret-mode
JAX programs."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import topk_scores_match
from repro.core import build_index as jax_build_index
from repro.core import twolevel as jax_twolevel
from repro.core.index import impact_doc_order
from repro.core.oracle import ranked_list
from repro.core.traversal import retrieve_batched as jax_retrieve
from repro.core.traversal import retrieve_sequential as jax_sequential
from repro_torch import bridge
from repro_torch.core import traversal, twolevel
from repro_torch.core.index import gather_tile
from repro_torch.core.traversal import (STAT_KEYS, retrieve_batched,
                                        retrieve_sequential)

CHUNK_STATS = ("chunks_dispatched", "n_chunks")

# (traversal, preset, k, schedule, bound_mode, use_kernel)
COVER = [
    ("full", "original", 10, "docid", "list", False),
    ("full", "gti", 100, "impact", "tile", True),
    ("full", "fast", 10, "impact", "list", True),
    ("full", "accurate", 100, "docid", "tile", False),
    ("chunked", "original", 100, "impact", "tile", True),
    ("chunked", "gti", 10, "impact", "list", False),
    ("chunked", "fast", 100, "impact", "tile", False),
    ("chunked", "accurate", 10, "impact", "list", True),
    ("chunked_fused", "original", 10, "impact", "tile", True),
    ("chunked_fused", "gti", 100, "impact", "list", True),
    ("chunked_fused", "fast", 10, "impact", "tile", True),
    ("chunked_fused", "accurate", 100, "impact", "list", True),
]


def _bridge(jidx):
    return bridge.index_from_arrays(
        {f.name: (None if getattr(jidx, f.name) is None
                  else np.asarray(getattr(jidx, f.name)))
         for f in dataclasses.fields(jidx)}, device="cpu")


@pytest.fixture(scope="module")
def setup(small_corpus):
    jidx = jax_build_index(small_corpus.merged("scaled"), tile_size=256)
    return small_corpus, jidx, _bridge(jidx)


def _q(corpus, rows=slice(None)):
    return (corpus.queries[rows], corpus.q_weights_b[rows],
            corpus.q_weights_l[rows])


def _params(module, preset, schedule, bound_mode, **kw):
    return getattr(module, preset)().replace(
        schedule=schedule, bound_mode=bound_mode, chunk_tiles=2, **kw)


def _assert_matches_reference(ref, port, keys):
    np.testing.assert_array_equal(ref.ids, port.ids)
    np.testing.assert_array_equal(ref.global_ids, port.global_ids)
    np.testing.assert_array_equal(ref.local_ids, port.local_ids)
    topk_scores_match(port.scores, ref.scores)
    assert set(ref.stats) == set(port.stats)
    for key in keys:
        np.testing.assert_array_equal(ref.stats[key], port.stats[key],
                                      err_msg=key)


@pytest.mark.parametrize(
    "traversal,preset,k,schedule,bound_mode,use_kernel", COVER,
    ids=[f"{c[0]}-{c[1]}-k{c[2]}-{c[3]}-{c[4]}-{'kern' if c[5] else 'plain'}"
         for c in COVER])
def test_retrieve_batched_matches_reference(setup, traversal, preset, k,
                                            schedule, bound_mode,
                                            use_kernel):
    corpus, jidx, tidx = setup
    ref = jax_retrieve(jidx, *_q(corpus),
                       _params(jax_twolevel, preset, schedule, bound_mode),
                       use_kernel=use_kernel, k=k, traversal=traversal)
    port = retrieve_batched(tidx, *_q(corpus),
                            _params(twolevel, preset, schedule, bound_mode),
                            use_kernel=use_kernel, k=k, traversal=traversal)
    keys = STAT_KEYS + ("n_tiles",)
    if traversal != "full":
        keys += CHUNK_STATS
    _assert_matches_reference(ref, port, keys)


@pytest.mark.parametrize("traversal", ["full", "chunked_fused"])
def test_reordered_index_and_threshold_factor_match_reference(small_corpus,
                                                              traversal):
    """A docid-reordered index (results mapped back through to_orig) under
    threshold over-estimation, which prunes hardest."""
    merged = small_corpus.merged("scaled")
    jidx = jax_build_index(merged, tile_size=128,
                           doc_order=impact_doc_order(merged))
    tidx = _bridge(jidx)
    kw = dict(threshold_factor=1.5)
    ref = jax_retrieve(jidx, *_q(small_corpus),
                       _params(jax_twolevel, "fast", "impact", "tile", **kw),
                       use_kernel=True, k=10, traversal=traversal)
    port = retrieve_batched(tidx, *_q(small_corpus),
                            _params(twolevel, "fast", "impact", "tile", **kw),
                            use_kernel=True, k=10, traversal=traversal)
    keys = STAT_KEYS + (CHUNK_STATS if traversal != "full" else ())
    _assert_matches_reference(ref, port, keys)


@pytest.mark.parametrize("schedule", ["docid", "impact"])
def test_retrieve_sequential_matches_reference(setup, schedule):
    corpus, jidx, tidx = setup
    rows = slice(0, 3)
    ref = jax_sequential(jidx, *_q(corpus, rows),
                         jax_twolevel.fast().replace(schedule=schedule),
                         warmup=False)
    port = retrieve_sequential(tidx, *_q(corpus, rows),
                               twolevel.fast().replace(schedule=schedule),
                               warmup=False)
    _assert_matches_reference(ref, port, STAT_KEYS + ("n_tiles",))
    assert port.latencies_ms.shape == (3,)
    assert (port.latencies_ms > 0).all()
    batched = retrieve_batched(tidx, *_q(corpus, rows),
                               twolevel.fast().replace(schedule=schedule))
    np.testing.assert_array_equal(port.ids, batched.ids)
    np.testing.assert_allclose(port.scores, batched.scores, rtol=1e-6)


# -- the port's own equivalences ---------------------------------------------

def _assert_identical(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    for key in STAT_KEYS:
        np.testing.assert_array_equal(a.stats[key], b.stats[key])


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "tile_kernel"])
@pytest.mark.parametrize("preset", ["rank_safe", "guided"])
def test_chunked_bit_identical_to_full_impact_scan(setup, preset,
                                                   use_kernel):
    """traversal='chunked' visits the descending-bound order, so it is
    bit-identical (ids, scores, every stat) to the full impact scan."""
    corpus, _, tidx = setup
    p = (twolevel.original(gamma=0.2) if preset == "rank_safe"
         else twolevel.fast()).replace(chunk_tiles=2)
    full = retrieve_batched(tidx, *_q(corpus), p.replace(schedule="impact"),
                            use_kernel=use_kernel)
    ck = retrieve_batched(tidx, *_q(corpus), p, traversal="chunked",
                          use_kernel=use_kernel)
    _assert_identical(full, ck)
    assert (ck.stats["chunks_dispatched"] <= ck.stats["n_chunks"]).all()


def test_chunked_fused_rank_safe_exact(setup):
    """Chunk-start thresholds keep rank-safe configs bound-exact: the fused
    chunk path equals the full impact scan and the exhaustive ranking."""
    corpus, _, tidx = setup
    p = twolevel.original(gamma=0.2).replace(chunk_tiles=2)
    full = retrieve_batched(tidx, *_q(corpus), p.replace(schedule="impact"))
    fu = retrieve_batched(tidx, *_q(corpus), p, traversal="chunked_fused",
                          use_kernel=True)
    np.testing.assert_array_equal(full.ids, fu.ids)
    np.testing.assert_allclose(full.scores, fu.scores, rtol=1e-6)
    merged = corpus.merged("scaled")
    for qi in range(len(corpus.queries)):
        ids, vals = ranked_list(merged, *_q(corpus, qi), 0.2, 10)
        topk_scores_match(fu.scores[qi], vals)


def test_chunked_early_exit_dispatches_fewer_chunks(small_corpus):
    jidx = jax_build_index(small_corpus.merged("scaled"), tile_size=64)
    tidx = _bridge(jidx)
    p = twolevel.gti().replace(chunk_tiles=4)
    full = retrieve_batched(tidx, *_q(small_corpus),
                            p.replace(schedule="impact"))
    ck = retrieve_batched(tidx, *_q(small_corpus), p, traversal="chunked")
    _assert_identical(full, ck)
    disp, n_chunks = ck.stats["chunks_dispatched"], ck.stats["n_chunks"]
    assert (full.stats["tiles_visited"] < full.stats["n_tiles"]).any()
    assert disp.sum() < n_chunks.sum()
    assert (disp * p.chunk_tiles >= ck.stats["tiles_visited"]).all()


def test_rejects_unknown_traversal(setup):
    corpus, _, tidx = setup
    with pytest.raises(ValueError, match="traversal"):
        retrieve_batched(tidx, *_q(corpus), twolevel.fast(),
                         traversal="tiled")


@pytest.fixture(scope="module")
def q8_index(small_corpus):
    from repro_torch.index import compress_index
    return compress_index(small_corpus.merged("scaled"), tile_size=256,
                          device="cpu")


def _visited_counts(tidx, q_terms, calls):
    """(present slots, postings) per row, summed over the tiles each step
    visited (``calls``: the (tiles, skip) of every ``step_inputs``),
    counted in numpy from ``core.index.gather_tile``'s offsets."""
    docids, w_b, w_l, tile_ptr = tidx.gather_arrays()
    present = np.zeros(len(q_terms))
    postings = np.zeros(len(q_terms))
    for tiles, skip in calls:
        tiles = tiles.reshape(len(q_terms), -1)
        skip = skip.reshape(len(q_terms), -1)
        for r, c in zip(*np.nonzero(~skip)):
            offs = gather_tile(docids, w_b, w_l, tile_ptr,
                               torch.from_numpy(q_terms[r]),
                               torch.tensor(int(tiles[r, c])),
                               pad_len=tidx.pad_len,
                               tile_size=tidx.tile_size)[0].numpy()
            present[r] += len(np.unique(offs[offs >= 0]))
            postings[r] += int((offs >= 0).sum())
    return present, postings


@pytest.mark.parametrize("kind,use_kernel", [
    ("fp32", False), ("fp32", True), ("q8", False), ("q8", True)])
def test_stats_count_pad_term_postings_on_every_traversal(
        setup, q8_index, monkeypatch, kind, use_kernel):
    """A batch padded with term 0 at weight 0, as the facade pads it:
    ``docs_present`` and ``postings_touched`` come from the scorer's 6th
    row, equal to a count made from the gathered offsets over the tiles
    each traversal visited, and equal on the three traversals at chunks of
    one tile (where the fused chunk's thresholds are each tile's)."""
    corpus, _, tidx = setup
    index = tidx if kind == "fp32" else q8_index
    pad = np.zeros((len(corpus.queries), 3), np.int32)
    q_terms = np.concatenate([corpus.queries.astype(np.int32), pad], 1)
    q_terms[::2, -1] = corpus.queries[::2, 0]          # a repeated real term
    qw_b, qw_l = (np.concatenate([w, pad.astype(np.float32)], 1)
                  for w in (corpus.q_weights_b, corpus.q_weights_l))
    p = twolevel.fast().replace(schedule="impact")
    calls = []

    def spy(ctx, carry, tiles, *a, **kw):
        x = real(ctx, carry, tiles, *a, **kw)
        calls.append((tiles.numpy().copy(), x.skip.numpy().copy()))
        return x
    real = traversal.step_inputs
    monkeypatch.setattr(traversal, "step_inputs", spy)
    got = {}       # the traversals at chunks of one tile
    for trav, ct in (("full", 1), ("chunked", 1), ("chunked_fused", 1),
                     ("chunked_fused", 4)):
        calls.clear()
        res = retrieve_batched(index, q_terms, qw_b, qw_l,
                               p.replace(chunk_tiles=ct),
                               use_kernel=use_kernel, traversal=trav)
        present, postings = _visited_counts(tidx, q_terms, calls)
        np.testing.assert_array_equal(res.stats["docs_present"], present)
        np.testing.assert_array_equal(res.stats["postings_touched"],
                                      postings)
        if ct == 1:
            got[trav] = res.stats
    assert (got["full"]["postings_touched"]
            > got["full"]["docs_present"]).all()
    for key in ("docs_present", "postings_touched", "tiles_visited"):
        np.testing.assert_array_equal(got["full"][key],
                                      got["chunked"][key])
        np.testing.assert_array_equal(got["full"][key],
                                      got["chunked_fused"][key])
