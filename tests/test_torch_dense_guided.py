"""The port's guided dense retrieval (``repro_torch.core.dense_guided``)
against the JAX package's, on the CPU.

``tests/test_dense_guided.py`` case for case (same names), each run on the
port and held against the reference on the same index: the reference's
built ``DenseGuidedIndex`` carried over by ``bridge.dense_index_from_arrays``
(``jnp.linalg.eigh`` and ``torch.linalg.eigh`` choose eigenvector signs,
and the order of near-equal eigenvalues, differently, so the port never
rebuilds the basis for a parity check). Ids are equal for rank-safe
settings, scores within ``topk_scores_match`` and ``candidates_fully_scored``
equal. The reference's compile-once test becomes a check that a repeated
``[B, D]`` search runs one batched scan, not one per query. Added: the
port's own ``build_dense_index`` (orthonormal basis, descending
eigenvalues, scores preserved, pad rows)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_scores_match
from repro.core import dense_guided as jdg
from repro.core.twolevel import TwoLevelParams as JaxParams
from repro_torch import bridge
from repro_torch.core import dense_guided as dg
from repro_torch.core.dense_guided import (build_dense_index,
                                           exhaustive_dense, retrieve_dense,
                                           retrieve_dense_batched)
from repro_torch.core.twolevel import TwoLevelParams
from repro_torch.retrieval import Retriever


def _emb():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 64)) * 2
    assign = rng.integers(0, 8, 4096)
    emb = centers[assign] + rng.standard_normal((4096, 64))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb[np.argsort(assign, kind="stable")].astype(np.float32)


@pytest.fixture(scope="module")
def jax_index():
    return jdg.build_dense_index(jnp.asarray(_emb()), block_size=512,
                                 d_cheap=16)


@pytest.fixture(scope="module")
def dense_index(jax_index):
    return bridge.dense_index_from_arrays(
        {f.name: np.asarray(getattr(jax_index, f.name))
         for f in dataclasses.fields(jax_index)}, device="cpu")


def _query(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(64).astype(np.float32)
    return q / np.linalg.norm(q)


def _query_batch(n=4):
    return np.stack([_query(seed) for seed in range(n)])


def _params(alpha, beta, gamma=0.0):
    return (TwoLevelParams(alpha=alpha, beta=beta, gamma=gamma),
            JaxParams(alpha=alpha, beta=beta, gamma=gamma))


def _same_as_reference(got, want, rank_safe):
    """(scores, ids, stats) of the port against the reference's."""
    topk_scores_match(got[0], np.asarray(want[0]))
    if rank_safe:
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(
        np.asarray(got[2]["candidates_fully_scored"]),
        np.asarray(want[2]["candidates_fully_scored"]))
    assert got[2]["n_candidates"] == want[2]["n_candidates"]


def test_rank_safe_equals_exhaustive(dense_index, jax_index):
    p, jp = _params(0.0, 0.0)
    for seed in range(3):
        q = _query(seed)
        got = retrieve_dense(dense_index, q, p)
        ev, ei = exhaustive_dense(dense_index, q, 10)
        np.testing.assert_allclose(got[0], ev, rtol=1e-5, atol=1e-5)
        assert set(got[1].tolist()) == set(ei.tolist())
        _same_as_reference(got, jdg.retrieve_dense(jax_index,
                                                   jnp.asarray(q), jp), True)
        jev, jei = jdg.exhaustive_dense(jax_index, jnp.asarray(q), 10)
        np.testing.assert_array_equal(ei, jei)
        topk_scores_match(ev, jev)


def test_pca_rotation_preserves_scores(dense_index):
    """Rotation must not change exact dot products (orthogonality)."""
    r = dense_index.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(64), atol=1e-4)


def test_guided_small_beta_keeps_recall(dense_index, jax_index):
    p, jp = _params(1.0, 0.2)
    rec = 0.0
    for seed in range(4):
        q = _query(seed)
        got = retrieve_dense(dense_index, q, p)
        _, ei = exhaustive_dense(dense_index, q, 10)
        rec += len(set(got[1].tolist()) & set(ei.tolist())) / 10
        _same_as_reference(got, jdg.retrieve_dense(jax_index,
                                                   jnp.asarray(q), jp), False)
    assert rec / 4 >= 0.9


def test_guided_beta_one_prunes_hard(dense_index, jax_index):
    p, jp = _params(1.0, 1.0)
    got = retrieve_dense(dense_index, _query(0), p)
    st = got[2]
    assert st["candidates_fully_scored"] < st["n_candidates"] * 0.5
    _same_as_reference(got, jdg.retrieve_dense(jax_index,
                                               jnp.asarray(_query(0)), jp),
                       False)


# -- registry-facade parity: the 'dense' engine behind Retriever.search
# reproduces exhaustive search exactly when rank-safe, and never exceeds
# it when guided ------------------------------------------------------------

def test_dense_engine_rank_safe_matches_exhaustive(dense_index, jax_index):
    from repro.retrieval import Retriever as JaxRetriever
    p, jp = _params(0.0, 0.0)
    r = Retriever.open(dense_index, p, engine="dense", device="cpu")
    q = _query_batch()
    resp = r.search(dense=q, k=10)
    for qi in range(q.shape[0]):
        ev, ei = exhaustive_dense(dense_index, q[qi], 10)
        np.testing.assert_allclose(resp.scores[qi], ev,
                                   rtol=1e-5, atol=1e-5)
        assert set(resp.ids[qi].tolist()) == set(ei.tolist())
        # untied positions must agree exactly (equal scores may swap)
        mism = resp.ids[qi] != ei
        if mism.any():
            tied = np.zeros_like(mism)
            close = np.abs(np.diff(ev)) < 1e-5
            tied[1:] |= close
            tied[:-1] |= close
            assert mism[~tied].sum() == 0
    want = JaxRetriever.open(jax_index, jp, engine="dense").search(
        dense=jnp.asarray(q), k=10)
    np.testing.assert_array_equal(resp.ids, want.ids)
    topk_scores_match(resp.scores, want.scores)
    np.testing.assert_array_equal(
        resp.stats["candidates_fully_scored"],
        want.stats["candidates_fully_scored"])


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.3), (1.0, 1.0)])
def test_dense_engine_guided_dominated_by_exhaustive(dense_index, jax_index,
                                                     alpha, beta):
    """Guided configs prune candidates, so at every rank the returned
    score can only be <= the exhaustive score at that rank."""
    from repro.retrieval import Retriever as JaxRetriever
    p, jp = _params(alpha, beta)
    r = Retriever.open(dense_index, p, engine="dense", device="cpu")
    q = _query_batch()
    resp = r.search(dense=q, k=10)
    for qi in range(q.shape[0]):
        ev, _ = exhaustive_dense(dense_index, q[qi], 10)
        got = resp.scores[qi]
        assert np.all(got <= ev + 1e-5)
        assert np.all(np.diff(got) <= 1e-6)    # sorted descending
        assert np.all(resp.ids[qi] >= 0)
    want = JaxRetriever.open(jax_index, jp, engine="dense").search(
        dense=jnp.asarray(q), k=10)
    topk_scores_match(resp.scores, want.scores)
    np.testing.assert_array_equal(
        resp.stats["candidates_fully_scored"],
        want.stats["candidates_fully_scored"])


@pytest.mark.parametrize("alpha,beta", [(0.0, 0.0), (1.0, 0.3)])
def test_batched_lane_matches_per_query(dense_index, jax_index, alpha,
                                        beta):
    """The [B, D] lane reproduces the per-query path: each row keeps its
    own block order and thresholds. Matched to float tolerance (the
    batched product may reduce in another order), and against the
    reference's batched lane."""
    p, jp = _params(alpha, beta)
    q = _query_batch(4)
    got = retrieve_dense_batched(dense_index, q, p, k=10)
    bv, bi, bst = got
    assert bv.shape == bi.shape == (4, 10)
    assert bst["candidates_fully_scored"].shape == (4,)
    assert bst["candidates_fully_scored"].dtype == np.float32
    for qi in range(4):
        vals, ids, st = retrieve_dense(dense_index, q[qi], p, k=10)
        np.testing.assert_allclose(bv[qi], vals, rtol=1e-5, atol=1e-5)
        overlap = len(set(bi[qi].tolist()) & set(ids.tolist()))
        assert overlap >= 9, (bi[qi], ids)
        assert bst["candidates_fully_scored"][qi] == pytest.approx(
            st["candidates_fully_scored"], abs=16)
    _same_as_reference(got, jdg.retrieve_dense_batched(
        jax_index, jnp.asarray(q), jp, k=10), alpha == beta == 0.0)


def test_batched_lane_rejects_single_queries(dense_index):
    with pytest.raises(ValueError, match=r"\[B, D\]"):
        retrieve_dense_batched(dense_index, _query(0),
                               TwoLevelParams(), k=10)


def test_dense_engine_compiles_once_per_batch_shape(dense_index,
                                                    monkeypatch):
    """The dense registry engine serves a [B, D] batch in one batched
    scan: repeated searches at the same (B, k) run one scan each, over all
    B rows, never one per query."""
    calls = []
    scan = dg._guided_scan

    def spy(index, q_rot, params, k):
        calls.append((tuple(q_rot.shape), k))
        return scan(index, q_rot, params, k)
    monkeypatch.setattr(dg, "_guided_scan", spy)
    r = Retriever.open(dense_index, TwoLevelParams(alpha=0.0, beta=0.0,
                                                   gamma=0.0),
                       engine="dense", device="cpu")
    r.search(dense=_query_batch(4), k=10)
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        q = rng.standard_normal((4, 64)).astype(np.float32)
        r.search(dense=q / np.linalg.norm(q, axis=1, keepdims=True), k=10)
    assert calls == [((4, 64), 10)] * 4


def test_dense_engine_requires_dense_queries(dense_index):
    r = Retriever.open(dense_index, TwoLevelParams(), engine="dense",
                       device="cpu")
    with pytest.raises(ValueError, match="dense"):
        r.search(terms=np.zeros((1, 2), np.int32),
                 weights_b=np.zeros((1, 2), np.float32),
                 weights_l=np.zeros((1, 2), np.float32), k=5)


# -- the port's own build ------------------------------------------------------

def test_build_dense_index_basis_and_scores():
    """The port's PCA basis: orthonormal, eigenvalues descending (the
    rotated coordinates' energy falls off), rotated dot products equal to
    the raw ones, and the same basis as the reference's up to each
    eigenvector's sign."""
    emb = _emb()
    idx = build_dense_index(emb, block_size=512, d_cheap=16, device="cpu")
    r = idx.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(64), atol=1e-5)
    energy = (idx.emb.numpy() ** 2).mean(0)
    assert np.all(np.diff(energy) <= 1e-6)
    q = _query(3)
    np.testing.assert_allclose(
        idx.emb.numpy() @ idx.rotate_query(torch.from_numpy(q)).numpy(),
        emb @ q, atol=2e-6)
    ref = np.asarray(jdg.build_dense_index(jnp.asarray(emb), block_size=512,
                                           d_cheap=16).rotation)
    # eigenvectors of well-separated eigenvalues agree up to sign
    cos = np.abs((r * ref).sum(0))
    assert (cos[:8] > 0.999).all()
    assert (idx.n_blocks, idx.block_size, idx.d_cheap) == (8, 512, 16)
    blocks = idx.emb.view(8, 512, 64)
    assert torch.equal(idx.bmax, blocks.amax(1))
    assert torch.equal(idx.bmin, blocks.amin(1))


def test_build_dense_index_pads_and_moves():
    """Rows pad with zeros to a multiple of the block size (as the
    reference's), ``exhaustive_dense`` keeps them, and ``.to`` returns the
    index itself when it is already on the device."""
    emb = _emb()[:1000]
    idx = build_dense_index(emb, block_size=256, d_cheap=8, device="cpu")
    assert idx.emb.shape == (1024, 64) and idx.n_blocks == 4
    assert torch.count_nonzero(idx.emb[1000:]) == 0
    assert idx.to("cpu") is idx
    assert idx.nbytes() == 4 * (1024 * 64 + 2 * 4 * 64 + 64 * 64)
    jidx = jdg.build_dense_index(jnp.asarray(emb), block_size=256,
                                 d_cheap=8)
    assert jidx.emb.shape == tuple(idx.emb.shape)
    q = -_query(1)
    _, ids = exhaustive_dense(idx, q, 1000)
    assert (ids >= 1000).any()          # pad rows compete (score 0)
