"""Cross-validation inside the port: the batched tile-scan engine (the
plain scorer and the ``guided_score`` kernel path, whose plain versions run
on the CPU) against the port's sequential numpy DAAT oracle's Q_Rk; the
port of ``tests/test_engine_parity.py``, on the same corpus.

Rank-safe configurations (alpha = beta = gamma) must agree: the same scores
and ids, except where adjacent scores tie (the order of equal scores
differs between the two traversals). Guided configurations are compared on
the returned scores: the oracle freezes docs eagerly per document, the
tile engine lazily per tile, so only the queue boundary may hold other
docs. The port's oracle is held to the reference's in
``tests/test_torch_data.py``."""
import numpy as np
import pytest

from repro_torch.core import build_index, twolevel
from repro_torch.core.oracle import daat_2gti
from repro_torch.core.traversal import retrieve_batched
from repro_torch.data import make_corpus

K = 10


@pytest.fixture(scope="module")
def setup():
    # conftest's small_corpus, built by the port
    corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                         n_queries=12, n_q_terms=5, n_rel=3,
                         avg_doc_terms=24, seed=7)
    merged = corpus.merged("scaled")
    index = build_index(merged, tile_size=256, device="cpu")
    return corpus, merged, index


def _search(corpus, index, p, use_kernel):
    return retrieve_batched(index, corpus.queries, corpus.q_weights_b,
                            corpus.q_weights_l, p, use_kernel=use_kernel)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("gamma", [0.0, 0.05, 0.3, 1.0])
def test_rank_safe_engine_matches_oracle_qrk(setup, use_kernel, gamma):
    corpus, merged, index = setup
    p = twolevel.original(gamma=gamma)
    res = _search(corpus, index, p, use_kernel)
    for qi in range(len(corpus.queries)):
        ids_o, vals_o, _ = daat_2gti(merged, corpus.queries[qi],
                                     corpus.q_weights_b[qi],
                                     corpus.q_weights_l[qi], p)
        valid = ids_o >= 0
        np.testing.assert_allclose(res.scores[qi][valid], vals_o[valid],
                                   rtol=2e-4, atol=1e-3)
        # ids must match except where adjacent scores tie
        eng, orc = res.ids[qi][valid], ids_o[valid]
        mism = eng != orc
        if mism.any():
            v = vals_o[valid]
            tied = np.zeros_like(mism)
            tied[1:] |= np.abs(np.diff(v)) < 1e-3
            tied[:-1] |= np.abs(np.diff(v)) < 1e-3
            assert mism[~tied].sum() == 0, (
                f"q{qi}: untied id mismatch engine={eng} oracle={orc}")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("preset", ["fast", "accurate", "gti"])
def test_guided_engine_scores_match_oracle_qrk(setup, use_kernel, preset):
    """Unsafe configurations: the head of Q_Rk agrees, the tail scores
    stay within 2% (either traversal may keep the slightly better
    boundary doc)."""
    corpus, merged, index = setup
    p = getattr(twolevel, preset)()
    res = _search(corpus, index, p, use_kernel)
    for qi in range(len(corpus.queries)):
        ids_o, vals_o, _ = daat_2gti(merged, corpus.queries[qi],
                                     corpus.q_weights_b[qi],
                                     corpus.q_weights_l[qi], p)
        valid = ids_o >= 0
        eng, orc = res.scores[qi][valid], vals_o[valid]
        np.testing.assert_allclose(eng[:K - 2], orc[:K - 2],
                                   rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(eng[K - 2:], orc[K - 2:],
                                   rtol=2e-2, atol=1e-2)


def test_kernel_and_plain_paths_identical_across_presets(setup):
    """Both execution paths of retrieve_batched are the same algorithm."""
    corpus, _, index = setup
    for p in (twolevel.fast(), twolevel.original(gamma=0.2),
              twolevel.fast().replace(bound_mode="tile")):
        r0 = _search(corpus, index, p, False)
        r1 = _search(corpus, index, p, True)
        np.testing.assert_array_equal(r0.ids, r1.ids)
        np.testing.assert_allclose(r0.scores, r1.scores, rtol=1e-6)
