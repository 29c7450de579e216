"""Property-based tests (hypothesis) of the paper's formal claims (§4.2) on
the port's ``retrieve_batched`` and oracle: the port of
``tests/test_properties.py``, with the same strategies and
``max_examples``.

Prop 1: any doc in the top-k of all three rankings R_alpha, R_beta, R_gamma
        is in 2GTI's output (engine and oracle).
Prop 2: with alpha = beta or beta = gamma, the mean R_gamma score of 2GTI's
        top-k >= that of the two-stage R2_{alpha,gamma} (oracle).
Plus: a rank-safe configuration equals exhaustive search, alignment
invariants, results sorted and unique.

One seeded draw of each property also holds the port's ids (and, for the
alignment invariants, its merged postings) to the reference's on the same
draw."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -e .[dev]); skipping, not failing")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import build_index as jax_build_index  # noqa: E402
from repro.core import oracle as jax_oracle  # noqa: E402
from repro.core import twolevel as jax_twolevel  # noqa: E402
from repro.core.traversal import retrieve_batched as jax_retrieve  # noqa: E402
from repro.data import make_corpus as jax_make_corpus  # noqa: E402
from repro_torch.core import build_index, twolevel  # noqa: E402
from repro_torch.core.oracle import (daat_2gti, ranked_list,  # noqa: E402
                                     score_all_merged, two_stage)
from repro_torch.core.traversal import retrieve_batched  # noqa: E402
from repro_torch.data import make_corpus  # noqa: E402

K = 8
GRID = [i / 20.0 for i in range(21)]
CORPUS = dict(n_docs=512, n_terms=128, n_queries=4, n_q_terms=4, n_rel=2,
              avg_doc_terms=12)


def _corpus(seed, make=make_corpus):
    return make("deepimpact_like", **CORPUS, seed=seed)


def _index(merged, build=build_index, **kw):
    return build(merged, tile_size=128, pad_multiple=128, **kw)


def _search(corpus, index, p, retrieve=retrieve_batched):
    return retrieve(index, corpus.queries, corpus.q_weights_b,
                    corpus.q_weights_l, p, k=K)


def _reference_search(seed, fill, p):
    """The reference engine on the same draw: ids [Q, K]."""
    corpus = _corpus(seed, jax_make_corpus)
    index = _index(corpus.merged(fill), jax_build_index)
    return np.asarray(_search(corpus, index, p, jax_retrieve).ids)


def _unique_topk(merged, qt, qwb, qwl, x, k):
    """Top-k of R_x; None when the boundary is tied (the paper assumes
    unique top-k subsets)."""
    s = score_all_merged(merged, qt, qwb, qwl, x)
    order = np.argsort(-s, kind="stable")
    if len(s) > k and abs(s[order[k - 1]] - s[order[k]]) < 1e-5:
        return None
    return set(int(d) for d in order[:k])


def check_prop1(seed, alpha, beta, gamma):
    corpus = _corpus(seed)
    merged = corpus.merged("scaled")
    p = twolevel.TwoLevelParams(alpha=alpha, beta=beta, gamma=gamma)
    res = _search(corpus, _index(merged, device="cpu"), p)
    for qi in range(len(corpus.queries)):
        qt, qwb, qwl = (corpus.queries[qi], corpus.q_weights_b[qi],
                        corpus.q_weights_l[qi])
        tops = [_unique_topk(merged, qt, qwb, qwl, x, K)
                for x in (alpha, beta, gamma)]
        if any(t is None for t in tops):
            continue  # a tie at the boundary: the precondition fails
        must_have = tops[0] & tops[1] & tops[2]
        got_engine = set(int(d) for d in res.ids[qi])
        assert must_have <= got_engine, (
            f"engine violated Prop 1: missing {must_have - got_engine}")
        ids_o, _, _ = daat_2gti(merged, qt, qwb, qwl, p, k=K)
        got_oracle = set(int(d) for d in ids_o)
        assert must_have <= got_oracle, (
            f"oracle violated Prop 1: missing {must_have - got_oracle}")
    return res.ids


def check_prop2(seed, alpha, gamma, tie, oracle=None):
    """Returns the 2GTI and two-stage ids of the first two queries."""
    corpus = _corpus(seed, jax_make_corpus if oracle else make_corpus)
    merged = corpus.merged("scaled")
    beta = alpha if tie == "alpha" else gamma
    tl = jax_twolevel if oracle else twolevel
    p = tl.TwoLevelParams(alpha=alpha, beta=beta, gamma=gamma)
    daat, stage, score_all = ((oracle.daat_2gti, oracle.two_stage,
                               oracle.score_all_merged) if oracle
                              else (daat_2gti, two_stage, score_all_merged))
    out = []
    for qi in range(2):
        qt, qwb, qwl = (corpus.queries[qi], corpus.q_weights_b[qi],
                        corpus.q_weights_l[qi])
        ids_o, _, _ = daat(merged, qt, qwb, qwl, p, k=K)
        s = score_all(merged, qt, qwb, qwl, gamma)
        ids_o = ids_o[ids_o >= 0]
        ids_2s, _ = stage(merged, qt, qwb, qwl, alpha, gamma, K)
        mean_2gti = float(s[ids_o].mean()) if len(ids_o) else 0.0
        mean_2s = float(s[ids_2s].mean()) if len(ids_2s) else 0.0
        assert mean_2gti >= mean_2s - 1e-4, (
            f"Prop 2 violated: {mean_2gti} < {mean_2s}")
        out.append((np.asarray(ids_o), np.asarray(ids_2s)))
    return out


def check_safe_config(seed, gamma):
    corpus = _corpus(seed)
    merged = corpus.merged("zero")
    res = _search(corpus, _index(merged, device="cpu"),
                  twolevel.original(gamma=gamma))
    for qi in range(len(corpus.queries)):
        _, vals = ranked_list(merged, corpus.queries[qi],
                              corpus.q_weights_b[qi],
                              corpus.q_weights_l[qi], gamma, K)
        np.testing.assert_allclose(res.scores[qi], vals, rtol=2e-4, atol=1e-3)
    return res.ids


def check_alignment(seed, fill, make=make_corpus):
    """Returns the filled merged postings."""
    corpus = _corpus(seed, make)
    m_zero = corpus.merged("zero")
    m_fill = corpus.merged(fill)
    assert m_fill.nnz == m_zero.nnz
    np.testing.assert_array_equal(m_fill.docids, m_zero.docids)
    np.testing.assert_allclose(m_fill.w_l, m_zero.w_l)
    existing = m_zero.w_b > 0
    np.testing.assert_allclose(m_fill.w_b[existing], m_zero.w_b[existing])
    assert np.all(m_fill.w_b[~existing] >= 0)
    return m_fill


def check_sorted_unique(seed):
    corpus = _corpus(seed)
    res = _search(corpus, _index(corpus.merged("scaled"), device="cpu"),
                  twolevel.fast())
    for qi in range(len(corpus.queries)):
        sc = res.scores[qi]
        finite = sc[np.isfinite(sc)]
        assert np.all(np.diff(finite) <= 1e-6), "scores must be descending"
        ids = res.ids[qi]
        ids = ids[ids >= 0]
        assert len(set(ids.tolist())) == len(ids), "duplicate docids"
    return res.ids


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 50), alpha=st.sampled_from(GRID),
       beta=st.sampled_from(GRID), gamma=st.sampled_from([0.0, 0.05, 0.3]))
def test_prop1_triple_topk_membership(seed, alpha, beta, gamma):
    check_prop1(seed, alpha, beta, gamma)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50), alpha=st.sampled_from(GRID),
       gamma=st.sampled_from([0.0, 0.05, 0.2]),
       tie=st.sampled_from(["alpha", "gamma"]))
def test_prop2_beats_two_stage(seed, alpha, gamma, tie):
    """alpha = beta or beta = gamma => mean R_gamma score of 2GTI >= R2."""
    check_prop2(seed, alpha, gamma, tie)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 50),
       gamma=st.sampled_from([0.0, 0.1, 0.5, 1.0]))
def test_safe_config_equals_exhaustive(seed, gamma):
    """alpha = beta = gamma is rank-safe: engine == exhaustive top-k
    scores."""
    check_safe_config(seed, gamma)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 50),
       fill=st.sampled_from(["zero", "one", "scaled"]))
def test_alignment_invariants(seed, fill):
    """Filling never alters existing BM25 weights and never drops
    postings."""
    check_alignment(seed, fill)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 50))
def test_result_sorted_and_unique(seed):
    check_sorted_unique(seed)


# -- one seeded draw of each, against the reference ---------------------------

@pytest.mark.parametrize("prop", ["prop1", "prop2", "safe_config",
                                  "alignment", "sorted_unique"])
def test_seeded_draw_matches_reference(prop):
    seed = 17
    if prop == "prop1":
        alpha, beta, gamma = 0.35, 0.7, 0.05
        ids = check_prop1(seed, alpha, beta, gamma)
        ref = _reference_search(seed, "scaled", jax_twolevel.TwoLevelParams(
            alpha=alpha, beta=beta, gamma=gamma))
    elif prop == "prop2":
        port = check_prop2(seed, 0.4, 0.05, "alpha")
        for (a_o, a_s), (b_o, b_s) in zip(
                port, check_prop2(seed, 0.4, 0.05, "alpha", jax_oracle)):
            np.testing.assert_array_equal(a_o, b_o)
            np.testing.assert_array_equal(a_s, b_s)
        return
    elif prop == "safe_config":
        ids = check_safe_config(seed, 0.1)
        ref = _reference_search(seed, "zero", jax_twolevel.original(
            gamma=0.1))
    elif prop == "alignment":
        port = check_alignment(seed, "one")
        ref = check_alignment(seed, "one", jax_make_corpus)
        for name in ("indptr", "docids", "w_b", "w_l"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
        return
    else:
        ids = check_sorted_unique(seed)
        ref = _reference_search(seed, "scaled", jax_twolevel.fast())
    np.testing.assert_array_equal(ids, ref)
