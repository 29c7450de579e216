"""The port's host-side copies and its index against the JAX package.

Same seeds, same numpy draws: the synthetic corpora, the merged postings,
the blocked layout and the index on the device must equal the reference's
array for array (``np.array_equal``, no tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as jax_build_index
from repro.core import index as jax_index
from repro.core import metrics as jax_metrics
from repro.core import oracle as jax_oracle
from repro.core import sparse as jax_sparse
from repro.core import twolevel as jax_twolevel
from repro.core.align import misalignment_fraction as jax_misalignment
from repro_torch import bridge
from repro_torch.core import build_index, index as t_index
from repro_torch.core import metrics as t_metrics
from repro_torch.core import oracle as t_oracle
from repro_torch.core import sparse as t_sparse
from repro_torch.core import twolevel as t_twolevel
from repro_torch.core.align import misalignment_fraction as t_misalignment
from repro_torch.data import make_corpus

# the two corpora of tests/conftest.py, by fixture name
CORPORA = {
    "small_corpus": ("splade_like", dict(n_docs=2048, n_terms=512,
                                         n_queries=12, n_q_terms=5, n_rel=3,
                                         avg_doc_terms=24, seed=7)),
    "aligned_corpus": ("unicoil_like", dict(n_docs=2048, n_terms=512,
                                            n_queries=8, n_q_terms=5,
                                            n_rel=3, avg_doc_terms=24,
                                            seed=11)),
}
INDEX_TENSORS = t_index.TENSOR_FIELDS


def _port_corpus(name):
    preset, kw = CORPORA[name]
    return make_corpus(preset, **kw)


def _fields(jidx) -> dict:
    return {f.name: (None if getattr(jidx, f.name) is None
                     else np.asarray(getattr(jidx, f.name)))
            for f in dataclasses.fields(jidx)}


def _assert_model_equal(a, b):
    assert (a.n_docs, a.n_terms) == (b.n_docs, b.n_terms)
    for f in ("indptr", "docids", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_make_corpus_bit_identical(request, name):
    ref = request.getfixturevalue(name)
    port = _port_corpus(name)
    _assert_model_equal(ref.bm25, port.bm25)
    _assert_model_equal(ref.learned, port.learned)
    np.testing.assert_array_equal(ref.bm25_stats.doc_lens,
                                  port.bm25_stats.doc_lens)
    np.testing.assert_array_equal(ref.bm25_stats.idf, port.bm25_stats.idf)
    for f in ("queries", "q_weights_l", "q_weights_b"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))
    assert ref.qrels == port.qrels
    assert ref.qrels_graded == port.qrels_graded
    assert ref.q_distractors == port.q_distractors


@pytest.mark.parametrize("fill", ["zero", "one", "scaled"])
def test_merged_postings_bit_identical(small_corpus, fill):
    ref = small_corpus.merged(fill)
    port = _port_corpus("small_corpus").merged(fill)
    for f in ("indptr", "docids", "w_b", "w_l"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))
    assert jax_misalignment(small_corpus.learned, small_corpus.bm25) == \
        t_misalignment(small_corpus.learned, small_corpus.bm25)


@pytest.mark.parametrize("reorder", [False, True], ids=["docid", "impact"])
@pytest.mark.parametrize("tile_size", [128, 512])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_blocked_layout_and_index_bit_identical(request, name, tile_size,
                                                reorder):
    ref_corpus = request.getfixturevalue(name)
    merged_ref = ref_corpus.merged("scaled")
    merged = _port_corpus(name).merged("scaled")
    order_ref = jax_index.impact_doc_order(merged_ref) if reorder else None
    order = t_index.impact_doc_order(merged) if reorder else None
    if reorder:
        np.testing.assert_array_equal(order_ref, order)
    lay_ref = jax_index.blocked_layout(merged_ref, tile_size,
                                       doc_order=order_ref)
    lay = t_index.blocked_layout(merged, tile_size, doc_order=order)
    assert lay_ref.keys() == lay.keys()
    for key, val in lay_ref.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, lay[key], err_msg=key)
            assert val.dtype == lay[key].dtype, key
        else:
            assert val == lay[key], key

    jidx = jax_build_index(merged_ref, tile_size=tile_size,
                           doc_order=order_ref)
    tidx = build_index(merged, tile_size=tile_size, doc_order=order,
                       device="cpu")
    for f in INDEX_TENSORS:
        np.testing.assert_array_equal(np.asarray(getattr(jidx, f)),
                                      getattr(tidx, f).numpy(), err_msg=f)
    assert tidx.docids.dtype == tidx.tile_ptr.dtype == torch.int32
    assert tidx.w_b.dtype == tidx.tile_max_l.dtype == torch.float32
    ids = np.array([[-1, 0, 5, tidx.n_docs - 1]], np.int32)
    np.testing.assert_array_equal(jidx.to_orig(ids), tidx.to_orig(ids))


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_tile_matches_reference(small_corpus, weighted):
    """The padded-run gather, one tile per query and a chunk of tiles per
    query (the sentinel tile id n_tiles included: an empty run)."""
    jidx = jax_build_index(small_corpus.merged("scaled"), tile_size=128)
    tidx = bridge.index_from_arrays(_fields(jidx), device="cpu")
    qt, qwb, qwl = (small_corpus.queries, small_corpus.q_weights_b,
                    small_corpus.q_weights_l)
    b = qt.shape[0]
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, jidx.n_tiles + 1, (b, 3)).astype(np.int32)
    tiles[0, 0] = jidx.n_tiles

    def jax_gather(q, t, wb, wl):
        return jax_index.gather_tile(
            jidx.docids, jidx.w_b, jidx.w_l, jidx.tile_ptr, q, t,
            wb if weighted else None, wl if weighted else None,
            pad_len=jidx.pad_len, tile_size=jidx.tile_size)
    ref = jax.vmap(jax.vmap(jax_gather, in_axes=(None, 0, None, None)))(
        jnp.asarray(qt), jnp.asarray(tiles), jnp.asarray(qwb),
        jnp.asarray(qwl))
    lead = (slice(None), None)
    port = t_index.gather_tile(
        tidx.docids, tidx.w_b, tidx.w_l, tidx.tile_ptr,
        torch.from_numpy(qt)[lead], torch.from_numpy(tiles),
        torch.from_numpy(qwb)[lead] if weighted else None,
        torch.from_numpy(qwl)[lead] if weighted else None,
        pad_len=tidx.pad_len, tile_size=tidx.tile_size)
    for name, a, t in zip(("offs", "wb", "wl"), ref, port):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=name)
    assert port[0].dtype == torch.int32
    assert (port[0][0, 0] == -1).all()              # sentinel: empty runs


@pytest.mark.parametrize("reorder", [False, True], ids=["docid", "impact"])
def test_bridge_round_trip(small_corpus, reorder):
    """index_from_arrays carries the reference index over unchanged: every
    field, dtype and the docid remap."""
    merged = small_corpus.merged("scaled")
    order = jax_index.impact_doc_order(merged) if reorder else None
    jidx = jax_build_index(merged, tile_size=256, doc_order=order)
    fields = _fields(jidx)
    tidx = bridge.index_from_arrays(fields, device="cpu")
    for f in bridge.SCALAR_FIELDS:
        assert getattr(tidx, f) == fields[f]
    for f in INDEX_TENSORS:
        t = getattr(tidx, f)
        assert t.device.type == "cpu"
        assert t.dtype == (torch.int32 if fields[f].dtype == np.int32
                           else torch.float32)
        np.testing.assert_array_equal(t.numpy(), fields[f])
    if reorder:
        np.testing.assert_array_equal(tidx.orig_of_new, jidx.orig_of_new)
    else:
        assert tidx.orig_of_new is None
    with pytest.raises(KeyError, match="docids"):
        bridge.index_from_arrays({k: v for k, v in fields.items()
                                  if k != "docids"}, device="cpu")


def test_cuda_without_gpu_raises(small_corpus):
    """No quiet fallback: asking for the card without one is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    merged = small_corpus.merged("scaled")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(merged, tile_size=256)          # device defaults to cuda
    tidx = build_index(merged, tile_size=256, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tidx.to("cuda")


def test_sparse_helpers_match(small_corpus):
    rng = np.random.default_rng(3)
    terms = rng.integers(0, 64, 500)
    docs = rng.integers(0, 100, 500)
    w = rng.random(500).astype(np.float32)
    _assert_model_equal(jax_sparse.from_coo(100, 64, terms, docs, w),
                        t_sparse.from_coo(100, 64, terms, docs, w))
    model = small_corpus.learned
    qt, qw = small_corpus.queries[0], small_corpus.q_weights_l[0]
    s_ref = jax_sparse.score_all(model, qt, qw)
    np.testing.assert_array_equal(s_ref, t_sparse.score_all(model, qt, qw))
    for a, b in zip(jax_sparse.exhaustive_topk(s_ref, 10),
                    t_sparse.exhaustive_topk(s_ref, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(model.max_weights(),
                                  t_sparse.SparseModel(
                                      model.n_docs, model.n_terms,
                                      model.indptr, model.docids,
                                      model.weights).max_weights())


@pytest.mark.parametrize("preset", ["original", "gti", "fast", "accurate"])
def test_oracle_matches(small_corpus, preset):
    merged = small_corpus.merged("scaled")
    q = (small_corpus.queries[1], small_corpus.q_weights_b[1],
         small_corpus.q_weights_l[1])
    ids_r, vals_r, st_r = jax_oracle.daat_2gti(
        merged, *q, getattr(jax_twolevel, preset)(), k=10)
    ids_t, vals_t, st_t = t_oracle.daat_2gti(
        merged, *q, getattr(t_twolevel, preset)(), k=10)
    np.testing.assert_array_equal(ids_r, ids_t)
    np.testing.assert_array_equal(vals_r, vals_t)
    assert st_r == st_t
    for a, b in zip(jax_oracle.two_stage(merged, *q, 1.0, 0.05, 10),
                    t_oracle.two_stage(merged, *q, 1.0, 0.05, 10)):
        np.testing.assert_array_equal(a, b)


def test_metrics_match(small_corpus):
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 2048, (12, 20))
    assert (jax_metrics.evaluate_run(ids, small_corpus.qrels, 20)
            == t_metrics.evaluate_run(ids, small_corpus.qrels, 20))
    lat = np.concatenate([rng.random(50) * 10, [np.nan, np.inf]])
    assert jax_metrics.mean_and_p99(lat) == t_metrics.mean_and_p99(lat)
    gains = {int(d): 2.0 for d in ids[0, :3]}
    assert (jax_metrics.ndcg_at_k(ids[0], gains, 10)
            == t_metrics.ndcg_at_k(ids[0], gains, 10))


def test_twolevel_presets_match():
    for name in ("original", "gt", "gti", "accurate", "fast",
                 "linear_combination"):
        a, b = getattr(jax_twolevel, name)(), getattr(t_twolevel, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert t_twolevel.resolve_k(t_twolevel.fast(), 7) == 7
    assert t_twolevel.resolve_k(None) == jax_twolevel.DEFAULT_K
    with pytest.raises(ValueError):
        t_twolevel.TwoLevelParams(bound_mode="block")
