"""The port's ``repro_torch.core.metrics`` against brute-force references
and against the JAX package's ``repro.core.metrics``, on the CPU.

``tests/test_metrics.py`` case for case (same names): duplicates count once,
sentinel ids (< 0) are never relevant, k beyond the list degrades
gracefully, ``mean_and_p99`` survives empty / NaN samples. Every metric the
cases compute on the port is also computed by the reference on the same
inputs and must be equal to it (both NaN where one is).
"""
import math

import numpy as np
import pytest

from repro.core import metrics as jax_metrics
from repro_torch.core import metrics as port_metrics


def _same(name, *args, **kw):
    """The port's ``name(*args)``, required equal to the reference's."""
    got = getattr(port_metrics, name)(*args, **kw)
    want = getattr(jax_metrics, name)(*args, **kw)
    flat_got = got if isinstance(got, (tuple, dict)) else (got,)
    flat_want = want if isinstance(want, (tuple, dict)) else (want,)
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        flat_got, flat_want = list(got.values()), list(want.values())
    for a, b in zip(flat_got, flat_want, strict=True):
        assert a == b or (math.isnan(a) and math.isnan(b)), (name, a, b)
    return got


def mrr_at_k(*a):
    return _same("mrr_at_k", *a)


def recall_at_k(*a):
    return _same("recall_at_k", *a)


def ndcg_at_k(*a):
    return _same("ndcg_at_k", *a)


def mean_and_p99(*a):
    return _same("mean_and_p99", *a)


def evaluate_run(*a, **kw):
    return _same("evaluate_run", *a, **kw)

# -- brute-force references (deliberately naive, set-based) -------------------

def _ref_mrr(ranked, relevant, k):
    for i, d in enumerate(list(ranked)[:k]):
        if d in relevant:
            return 1.0 / (i + 1)
    return 0.0


def _ref_recall(ranked, relevant, k):
    if not relevant:
        return 0.0
    return len(set(list(ranked)[:k]) & relevant) / len(relevant)


def _ref_ndcg(ranked, gains, k):
    dcg, seen = 0.0, set()
    for i, d in enumerate(list(ranked)[:k]):
        if d in seen:
            continue
        seen.add(d)
        dcg += (2.0 ** gains.get(d, 0.0) - 1.0) / np.log2(i + 2)
    ideal = sorted(gains.values(), reverse=True)[:k]
    idcg = sum((2.0 ** g - 1.0) / np.log2(i + 2)
               for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def _random_case(rng):
    n = int(rng.integers(1, 40))
    ranked = rng.integers(-1, 30, size=n)          # includes -1 sentinels
    relevant = {int(d) for d in rng.integers(0, 30,
                                             size=rng.integers(0, 8))}
    gains = {d: float(rng.integers(1, 4)) for d in relevant}
    k = int(rng.integers(1, 50))                   # often > len(ranked)
    return ranked, relevant, gains, k


@pytest.mark.parametrize("seed", range(20))
def test_metrics_match_bruteforce(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        ranked, relevant, gains, k = _random_case(rng)
        ref_ranked = [int(d) for d in ranked]
        assert mrr_at_k(ranked, relevant, k) == pytest.approx(
            _ref_mrr(ref_ranked, relevant, k))
        assert recall_at_k(ranked, relevant, k) == pytest.approx(
            _ref_recall(ref_ranked, relevant, k))
        assert ndcg_at_k(ranked, gains, k) == pytest.approx(
            _ref_ndcg(ref_ranked, gains, k))


def test_metrics_bounded_and_monotone_in_k():
    rng = np.random.default_rng(3)
    for _ in range(25):
        ranked, relevant, gains, _ = _random_case(rng)
        prev_r = prev_m = 0.0
        for k in range(1, len(ranked) + 3):
            m = mrr_at_k(ranked, relevant, k)
            r = recall_at_k(ranked, relevant, k)
            n = ndcg_at_k(ranked, gains, k)
            assert 0.0 <= m <= 1.0 and 0.0 <= r <= 1.0 and 0.0 <= n <= 1.0
            assert r >= prev_r - 1e-12      # recall never drops with k
            assert m >= prev_m - 1e-12      # first hit only gets closer
            prev_r, prev_m = r, m


# -- edge cases the guards exist for ------------------------------------------

def test_empty_relevant_set_scores_zero():
    ranked = np.array([3, 1, 2])
    assert mrr_at_k(ranked, set(), 10) == 0.0
    assert recall_at_k(ranked, set(), 10) == 0.0
    assert ndcg_at_k(ranked, {}, 10) == 0.0


def test_k_larger_than_ranked_list():
    ranked = np.array([5, 7])
    assert mrr_at_k(ranked, {7}, 100) == 0.5
    assert recall_at_k(ranked, {7, 9}, 100) == 0.5
    assert ndcg_at_k(ranked, {7: 1.0}, 100) == pytest.approx(
        (1.0 / np.log2(3)))


def test_duplicate_ids_count_once():
    ranked = np.array([4, 4, 4, 9])
    assert recall_at_k(ranked, {4, 9}, 4) == 1.0          # not 3/2
    # dup occurrences earn no extra DCG, and don't block later docs
    with_dups = ndcg_at_k(ranked, {4: 1.0, 9: 1.0}, 4)
    no_dups = ndcg_at_k(np.array([4, 9]), {4: 1.0, 9: 1.0}, 4)
    assert with_dups <= no_dups
    assert with_dups == pytest.approx(
        (1.0 + 1.0 / np.log2(5)) / (1.0 + 1.0 / np.log2(3)))


def test_sentinel_ids_never_relevant():
    ranked = np.array([-1, -1, 8])
    assert mrr_at_k(ranked, {8}, 10) == pytest.approx(1.0 / 3)
    assert recall_at_k(ranked, {8}, 10) == 1.0
    # a hostile relevant set containing -1 must not turn sentinels
    # into hits
    assert recall_at_k(np.array([-1, -1]), {-1, 8}, 10) == 0.0
    assert mrr_at_k(np.array([-1, 3]), {-1, 3}, 10) == 0.5
    assert ndcg_at_k(np.array([-1, 3]), {-1: 2.0, 3: 1.0}, 10) < 1.0


def test_mean_and_p99_guards():
    mean, p99 = mean_and_p99(np.array([]))
    assert np.isnan(mean) and np.isnan(p99)
    mean, p99 = mean_and_p99(np.array([np.nan, np.nan]))
    assert np.isnan(mean) and np.isnan(p99)
    # non-finite entries are dropped, not averaged in; p99 is the
    # exact-rank quantile (a latency some query took), not interpolated
    mean, p99 = mean_and_p99(np.array([1.0, np.nan, 3.0, np.inf]))
    assert mean == pytest.approx(2.0)
    assert p99 == pytest.approx(3.0)
    mean, p99 = mean_and_p99(np.array([5.0]))
    assert mean == 5.0 and p99 == 5.0


def test_evaluate_run_aggregates():
    ids = np.array([[1, 2, 3], [9, 9, 9]])
    qrels = [{1}, {7}]
    m = evaluate_run(ids, qrels, k=3)
    assert m["mrr"] == pytest.approx(0.5)
    assert m["recall"] == pytest.approx(0.5)
    assert 0.0 <= m["ndcg"] <= 1.0


# -- hypothesis deepening (these two skip cleanly when unavailable; the
# randomized-seed coverage above runs regardless) -----------------------------

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    ranked_lists = st.lists(st.integers(min_value=-1, max_value=25),
                            min_size=0, max_size=30)
    rel_sets = st.sets(st.integers(min_value=0, max_value=25), max_size=8)

    @settings(max_examples=200, deadline=None)
    @given(ranked=ranked_lists, relevant=rel_sets,
           k=st.integers(min_value=1, max_value=40))
    def test_hyp_binary_metrics_match_reference(ranked, relevant, k):
        arr = np.array(ranked, dtype=np.int64).reshape(-1)
        assert mrr_at_k(arr, relevant, k) == pytest.approx(
            _ref_mrr(ranked, relevant, k))
        assert recall_at_k(arr, relevant, k) == pytest.approx(
            _ref_recall(ranked, relevant, k))

    @settings(max_examples=200, deadline=None)
    @given(ranked=ranked_lists,
           gains=st.dictionaries(st.integers(min_value=0, max_value=25),
                                 st.floats(min_value=0.5, max_value=4.0),
                                 max_size=8),
           k=st.integers(min_value=1, max_value=40))
    def test_hyp_ndcg_matches_reference_and_is_bounded(ranked, gains, k):
        arr = np.array(ranked, dtype=np.int64).reshape(-1)
        got = ndcg_at_k(arr, gains, k)
        assert got == pytest.approx(_ref_ndcg(ranked, gains, k))
        assert 0.0 <= got <= 1.0 + 1e-9
else:
    @pytest.mark.skip(reason="hypothesis not installed; the randomized-"
                      "seed reference coverage above still ran")
    def test_hyp_property_suite():
        pass
