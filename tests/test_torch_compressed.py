"""The port's compressed (q8) index and its serving path against the JAX
package's, on the conftest corpora.

- the build: every array of ``compress_index`` equals the reference's
  (``packed`` as its int32 bitcast, ``first`` widened to int32), on both
  corpora, at tile sizes 128 and 256, with and without ``doc_order``;
- ``save``/``load`` read each other's npz, both ways;
- the gathers: ``gather_tile_q`` offsets equal the reference's and the fp32
  gather's, its weights the reference's; ``gather_tile_q_raw`` equals the
  reference's (codes compared as integers), the sentinel tile included;
- retrieval: on every engine/traversal/preset/k of the covering set, ids
  and every stat equal the JAX q8 path's, scores within
  ``topk_scores_match`` (XLA contracts the combines into fused
  multiply-adds, the port rounds each product).
The sharded and hybrid q8 paths are not ported yet."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import topk_scores_match
from repro.core import twolevel as jax_twolevel
from repro.core.index import impact_doc_order
from repro.core.traversal import retrieve_sequential as jax_sequential
from repro.index import CompressedImpactIndex as JaxCompressed
from repro.index import compress_index as jax_compress
from repro.index.compressed import gather_tile_q as jax_gather_q
from repro.index.compressed import gather_tile_q_raw as jax_gather_raw
from repro.retrieval import Retriever as JaxRetriever
from repro_torch import bridge
from repro_torch.core import build_index, twolevel
from repro_torch.core.index import gather_tile
from repro_torch.core.traversal import (STAT_KEYS, retrieve_batched,
                                        retrieve_sequential)
from repro_torch.index import (CompressedImpactIndex, compress_index,
                               gather_tile_q, gather_tile_q_raw)
from repro_torch.index.compressed import TENSOR_FIELDS
from repro_torch.retrieval import Retriever

K = 10


def _fields(jidx) -> dict:
    return {f.name: (None if getattr(jidx, f.name) is None
                     else np.asarray(getattr(jidx, f.name)))
            for f in dataclasses.fields(jidx)}


def _assert_index_equal(jidx, tidx):
    """Field by field: scalars equal; tensors equal in value, in the
    port's device dtypes."""
    for name, ref in _fields(jidx).items():
        port = getattr(tidx, name)
        if name in TENSOR_FIELDS:
            want = {"packed": lambda a: a.view(np.int32),
                    "first": lambda a: a.astype(np.int32)}.get(
                        name, lambda a: a)(ref)
            got = port.cpu().numpy()
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif ref is None or port is None:
            assert ref is None and port is None, name
        else:
            np.testing.assert_array_equal(port, ref, err_msg=name)


@pytest.fixture(scope="module")
def setup(small_corpus):
    merged = small_corpus.merged("scaled")
    jidx = jax_compress(merged, tile_size=256)
    tidx = bridge.compressed_from_arrays(_fields(jidx), device="cpu")
    return small_corpus, merged, jidx, tidx


# -- the build -----------------------------------------------------------------

@pytest.mark.parametrize("doc_order", [False, True],
                         ids=["docid", "impact_order"])
@pytest.mark.parametrize("tile_size", [128, 256])
@pytest.mark.parametrize("corpus", ["small_corpus", "aligned_corpus"])
def test_compress_index_equals_reference(request, corpus, tile_size,
                                         doc_order):
    merged = request.getfixturevalue(corpus).merged("scaled")
    order = impact_doc_order(merged) if doc_order else None
    jidx = jax_compress(merged, tile_size=tile_size, doc_order=order)
    tidx = compress_index(merged, tile_size=tile_size, doc_order=order,
                          device="cpu")
    _assert_index_equal(jidx, tidx)
    assert tidx.gather_kind == "q8" and tidx.device == torch.device("cpu")
    ids = np.array([[-1, 0, 5, tidx.n_docs - 1]], np.int32)
    np.testing.assert_array_equal(tidx.to_orig(ids), jidx.to_orig(ids))


def test_geometry_bounds_and_bytes_match_fp32(setup):
    _, merged, jidx, tidx = setup
    fp32 = build_index(merged, tile_size=256, device="cpu")
    assert (tidx.n_docs, tidx.n_terms, tidx.n_tiles, tidx.pad_len,
            tidx.nnz) == (fp32.n_docs, fp32.n_terms, fp32.n_tiles,
                          fp32.pad_len, fp32.nnz)
    for f in ("tile_ptr", "tile_max_b", "tile_max_l", "sigma_b", "sigma_l"):
        torch.testing.assert_close(getattr(tidx, f), getattr(fp32, f),
                                   rtol=0, atol=0)
    nb = tidx.nbytes()
    assert nb["total"] == sum(v for k, v in nb.items() if k != "total")
    # every field as the reference counts it, but `first` held as int32
    ref = jidx.nbytes()
    assert nb["first"] == 2 * ref["first"]
    assert nb["total"] - nb["first"] == ref["total"] - ref["first"]
    assert tidx.fp32_nbytes() == jidx.fp32_nbytes() == fp32.nbytes()
    assert nb["total"] < 0.5 * tidx.fp32_nbytes()


@pytest.mark.parametrize("doc_order", [False, True],
                         ids=["docid", "impact_order"])
def test_save_load_reads_reference_npz_both_ways(small_corpus, tmp_path,
                                                  doc_order):
    merged = small_corpus.merged("scaled")
    order = impact_doc_order(merged) if doc_order else None
    jidx = jax_compress(merged, tile_size=256, doc_order=order)
    tidx = compress_index(merged, tile_size=256, doc_order=order,
                          device="cpu")
    tidx.save(tmp_path / "port.npz")
    jidx.save(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name
    _assert_index_equal(JaxCompressed.load(tmp_path / "port.npz"), tidx)
    _assert_index_equal(jidx, CompressedImpactIndex.load(
        tmp_path / "ref.npz", device="cpu"))


# -- the gathers ---------------------------------------------------------------

def _flat_query_terms(corpus):
    return (corpus.queries.reshape(-1).astype(np.int32),
            corpus.q_weights_b.reshape(-1), corpus.q_weights_l.reshape(-1))


@pytest.mark.parametrize("tile", [0, 3, 7])
def test_gather_tile_q_matches_reference_and_fp32(setup, tile):
    corpus, merged, jidx, tidx = setup
    qt, qwb, qwl = _flat_query_terms(corpus)
    ref = jax_gather_q(jidx.gather_arrays(), qt, tile, qwb, qwl,
                       pad_len=jidx.pad_len, tile_size=jidx.tile_size)
    t = [torch.from_numpy(a) for a in (qt, qwb, qwl)]
    port = gather_tile_q(tidx.gather_arrays(), t[0], torch.tensor(tile),
                         t[1], t[2], pad_len=tidx.pad_len)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    fp32 = build_index(merged, tile_size=256, device="cpu")
    offs32, _, _ = gather_tile(fp32.docids, fp32.w_b, fp32.w_l,
                               fp32.tile_ptr, t[0], torch.tensor(tile),
                               pad_len=fp32.pad_len,
                               tile_size=fp32.tile_size)
    torch.testing.assert_close(port[0], offs32, rtol=0, atol=0)
    # unweighted: the raw dequantized impacts
    ref_raw = jax_gather_q(jidx.gather_arrays(), qt, tile,
                           pad_len=jidx.pad_len, tile_size=jidx.tile_size)
    port_raw = gather_tile_q(tidx.gather_arrays(), t[0], torch.tensor(tile),
                             pad_len=tidx.pad_len)
    for a, b in zip(ref_raw, port_raw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gathers_are_batched_and_clamp_the_sentinel_tile(setup):
    """A [B, C] batch of (query, tile) rows, sentinel tile id n_tiles
    included, equals the reference's per-row raw and decoded gathers;
    codes are compared as integers."""
    corpus, _, jidx, tidx = setup
    rng = np.random.default_rng(0)
    b, c = corpus.queries.shape[0], 3
    tiles = rng.integers(0, jidx.n_tiles, (b, c)).astype(np.int32)
    tiles[:, -1] = jidx.n_tiles
    qt = torch.from_numpy(corpus.queries.astype(np.int32))[:, None]
    qwb = torch.from_numpy(corpus.q_weights_b)[:, None]
    qwl = torch.from_numpy(corpus.q_weights_l)[:, None]
    raw = gather_tile_q_raw(tidx.gather_arrays(), qt, torch.from_numpy(tiles),
                            pad_len=tidx.pad_len)
    dec = gather_tile_q(tidx.gather_arrays(), qt, torch.from_numpy(tiles),
                        qwb, qwl, pad_len=tidx.pad_len)
    assert raw[1].dtype == torch.uint8 and raw[3].shape == (b, c, 3,
                                                             qt.shape[-1])
    for i in range(b):
        for j in range(c):
            ref = jax_gather_raw(jidx.gather_arrays(), corpus.queries[i],
                                 int(tiles[i, j]), pad_len=jidx.pad_len)
            for a, p in zip(ref, raw):
                got, want = p[i, j].numpy(), np.asarray(a)
                if p.dtype == torch.uint8:      # codes: f32 in the reference
                    got, want = got.astype(np.int64), want.astype(np.int64)
                np.testing.assert_array_equal(got, want)
            if tiles[i, j] < jidx.n_tiles:
                ref = jax_gather_q(jidx.gather_arrays(), corpus.queries[i],
                                   int(tiles[i, j]), corpus.q_weights_b[i],
                                   corpus.q_weights_l[i],
                                   pad_len=jidx.pad_len,
                                   tile_size=jidx.tile_size)
                for a, p in zip(ref, dec):
                    np.testing.assert_array_equal(p[i, j].numpy(),
                                                  np.asarray(a))
    sentinel = raw[3][:, -1]
    assert (sentinel[:, 0] == 0).all()                 # cnt 0
    assert (dec[0][:, -1] == -1).all()                 # decodes to nothing


# -- retrieval -----------------------------------------------------------------

# (engine, traversal, preset, k): each engine/traversal pair with both
# presets and both depths
COVER = [
    ("batched", "full", "original", 10),
    ("batched", "full", "fast", 100),
    ("batched", "chunked", "original", 100),
    ("batched", "chunked", "fast", 10),
    ("kernel", "full", "original", 100),
    ("kernel", "full", "fast", 10),
    ("kernel", "chunked", "original", 10),
    ("kernel", "chunked", "fast", 100),
    ("kernel", "chunked_fused", "original", 100),
    ("kernel", "chunked_fused", "fast", 10),
]


def _queries(corpus, rows=slice(None)):
    return dict(terms=corpus.queries[rows],
                weights_b=corpus.q_weights_b[rows],
                weights_l=corpus.q_weights_l[rows])


def _params(module, preset):
    return getattr(module, preset)().replace(chunk_tiles=2)


def _assert_same_result(ref, port, stat_keys):
    np.testing.assert_array_equal(ref.ids, port.ids)
    topk_scores_match(port.scores, ref.scores)
    for key in stat_keys:
        np.testing.assert_array_equal(ref.stats[key], port.stats[key],
                                      err_msg=key)


@pytest.mark.parametrize("engine,traversal,preset,k", COVER,
                         ids=["-".join(map(str, c)) for c in COVER])
def test_q8_search_matches_reference(setup, engine, traversal, preset, k):
    corpus, _, jidx, tidx = setup
    ref = JaxRetriever.open(jidx, _params(jax_twolevel, preset),
                            engine=engine, traversal=traversal
                            ).search(**_queries(corpus), k=k)
    port = Retriever.open(tidx, _params(twolevel, preset), engine=engine,
                          traversal=traversal, device="cpu"
                          ).search(**_queries(corpus), k=k)
    keys = STAT_KEYS + ("n_tiles",)
    if traversal != "full":
        keys += ("chunks_dispatched", "n_chunks")
    _assert_same_result(ref, port, keys)


def test_q8_sequential_matches_reference(setup):
    corpus, _, jidx, tidx = setup
    q = tuple(_queries(corpus, slice(0, 3)).values())
    ref = jax_sequential(jidx, *q, jax_twolevel.fast(), warmup=False, k=K)
    port = retrieve_sequential(tidx, *q, twolevel.fast(), warmup=False, k=K)
    _assert_same_result(ref, port, STAT_KEYS + ("n_tiles",))
    np.testing.assert_array_equal(ref.global_ids, port.global_ids)
    np.testing.assert_array_equal(ref.local_ids, port.local_ids)
    r = Retriever.open(tidx, twolevel.fast(), engine="sequential",
                       device="cpu", warmup=False).search(
                           **_queries(corpus, slice(0, 3)), k=K)
    np.testing.assert_array_equal(r.ids, port.ids)


def test_bridged_index_searches_as_the_ports_own_build(setup):
    """``bridge.compressed_from_arrays`` of the reference index and the
    port's ``compress_index`` hold the same arrays and serve the same
    results."""
    corpus, merged, _, tidx = setup
    own = compress_index(merged, tile_size=256, device="cpu")
    for f in TENSOR_FIELDS:
        torch.testing.assert_close(getattr(own, f), getattr(tidx, f),
                                   rtol=0, atol=0)
    a, b = (Retriever.open(index, twolevel.fast(), engine="kernel",
                           traversal="chunked_fused", device="cpu"
                           ).search(**_queries(corpus), k=K)
            for index in (own, tidx))
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    for key in STAT_KEYS:
        np.testing.assert_array_equal(a.stats[key], b.stats[key])


@pytest.mark.parametrize("traversal", ["full", "chunked"])
def test_decode_in_kernel_path_equals_plain_decode(setup, traversal):
    """The kernel path's plain versions (raw rows, in-scorer decode, row-5
    stats) and the plain path (decoding gather, offset-derived stats)
    decode the same integers: identical ids, scores and stats."""
    corpus, _, _, tidx = setup
    q = tuple(_queries(corpus).values())
    p = twolevel.fast().replace(chunk_tiles=2)
    plain = retrieve_batched(tidx, *q, p, use_kernel=False, k=K,
                             traversal=traversal)
    kern = retrieve_batched(tidx, *q, p, use_kernel=True, k=K,
                            traversal=traversal)
    np.testing.assert_array_equal(plain.ids, kern.ids)
    np.testing.assert_array_equal(plain.scores, kern.scores)
    for key in STAT_KEYS:
        np.testing.assert_array_equal(plain.stats[key], kern.stats[key])


def test_q8_close_to_fp32_and_engines_accept_it(setup):
    """Rank-safe q8 retrieval returns the fp32 top-k up to quantization
    (overlap >= 0.95, scores within the quantization step); the engines
    take either index type and nothing else."""
    corpus, merged, _, tidx = setup
    fp32 = build_index(merged, tile_size=256, device="cpu")
    p = twolevel.original(gamma=0.05)
    ref = Retriever.open(fp32, p, device="cpu").search(**_queries(corpus),
                                                       k=K)
    for engine in ("batched", "kernel", "sequential"):
        resp = Retriever.open(tidx, p, engine=engine, device="cpu").search(
            **_queries(corpus), k=K)
        overlap = np.mean([len(set(a) & set(b)) / K
                           for a, b in zip(resp.ids, ref.ids)])
        assert overlap >= 0.95, engine
        np.testing.assert_allclose(resp.scores, ref.scores, rtol=5e-2,
                                   atol=5e-2)
    with pytest.raises(TypeError, match="CompressedImpactIndex"):
        Retriever.open(object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Retriever.open(tidx, p)                      # device="cuda"
