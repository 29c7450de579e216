"""The port's relevance harness (``repro_torch.eval``) against the JAX
package's, on the CPU.

Nine of ``tests/test_eval_harness.py``'s eleven cases (same names), on the
port: the graded corpus, TREC interchange, ``evaluate_retriever`` and the
paper's small-k claim (guided degradation, two-level and cascade
recovery), each also equal to the reference's numbers on the same inputs.
``test_quality_bench_is_deterministic`` and
``test_committed_baseline_cascade_beats_sparse`` read the JAX package's
``benchmarks/quality_bench.py`` and its committed ``BENCH_quality.json``;
they wait for the port's benchmarks.

Added: ``make_graded_corpus`` bit-identical to the reference's; its
``.corpus`` at ``n_rel_partial=0`` identical to ``make_corpus`` with the same
arguments; and every lane of ``quality_bench``'s grid (method x
threshold_factor x engine, the dense-only lane and the cascade depth
frontier) giving the same ``evaluate_ranking`` numbers on the port as on
the reference, over the same carried hybrid index."""
import dataclasses

import numpy as np
import pytest

from repro.core import twolevel as jax_twolevel
from repro.eval import build_hybrid as jax_build_hybrid
from repro.eval import evaluate_ranking as jax_evaluate_ranking
from repro.eval import load_qrels as jax_load_qrels
from repro.eval import load_run as jax_load_run
from repro.eval import make_graded_corpus as jax_graded
from repro.eval import write_run as jax_write_run
from repro.eval.synthetic import _embed_queries_np as jax_embed_np
from repro.retrieval import Retriever as JaxRetriever
from repro.retrieval import hybrid as jhy
from repro_torch import bridge
from repro_torch.core import twolevel
from repro_torch.data import make_corpus
from repro_torch.eval import (build_hybrid, evaluate_ranking,
                              evaluate_retriever, evaluate_trec, load_qrels,
                              load_run, make_graded_corpus, write_run)
from repro_torch.eval.synthetic import _embed_queries_np
from repro_torch.retrieval import Retriever
from repro_torch.retrieval.hybrid import dense_topk, embed_queries

GRADED = dict(n_docs=4096, n_terms=1024, n_queries=32, dim=32, seed=0)


def _fields(x):
    return {f.name: (None if getattr(x, f.name) is None
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def graded():
    """The quality_bench corpus (same knobs, same seed)."""
    return make_graded_corpus(**GRADED)


@pytest.fixture(scope="module")
def hybrid(graded):
    return build_hybrid(graded, tile_size=128, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """The reference's graded corpus and hybrid index, and the port's copy
    of that index (its PCA basis included)."""
    jg = jax_graded(**GRADED)
    jh = jax_build_hybrid(jg, tile_size=128)
    return jg, jh, bridge.hybrid_index_from_arrays(
        _fields(jh.sparse), _fields(jh.dense), np.asarray(jh.q_proj),
        device="cpu")


def _mrr10(hybrid, graded, engine, params, tf, **opts):
    r = Retriever.open(hybrid, params, engine=engine, device="cpu", **opts)
    resp = r.search(k=10, threshold_factor=tf, **graded.queries())
    return evaluate_ranking(resp.ids, graded.qrels)["mrr@10"]


def _jax_mrr10(jh, jg, engine, params, tf, **opts):
    r = JaxRetriever.open(jh, params, engine=engine, **opts)
    resp = r.search(k=10, threshold_factor=tf, **jg.queries())
    return jax_evaluate_ranking(resp.ids, jg.qrels)["mrr@10"]


# -- graded corpus properties -------------------------------------------------

def test_graded_corpus_structure(graded):
    c = graded.corpus
    assert len(graded.qrels) == 32
    for gains, rel, dis in zip(graded.qrels, c.qrels, c.q_distractors):
        grades = set(gains.values())
        assert grades <= {1.0, 2.0} and 2.0 in grades
        assert {d for d, g in gains.items() if g == 2.0} == rel
        assert sum(1 for g in gains.values() if g == 1.0) == 3
        assert not (set(gains) & dis)       # distractors are non-relevant
    assert graded.doc_emb.shape == (4096, 32)
    np.testing.assert_allclose(np.linalg.norm(graded.doc_emb, axis=1),
                               1.0, atol=1e-5)


def test_graded_corpus_is_seed_pinned(graded):
    again = make_graded_corpus(**GRADED)
    np.testing.assert_array_equal(again.doc_emb, graded.doc_emb)
    np.testing.assert_array_equal(again.q_proj, graded.q_proj)
    assert again.qrels == graded.qrels
    np.testing.assert_array_equal(again.corpus.queries,
                                  graded.corpus.queries)


def test_graded_corpus_is_the_references(graded, carried):
    """Bit-identical to ``repro.eval.make_graded_corpus``: embeddings,
    projection, judgments, distractors, queries and postings."""
    jg = carried[0]
    np.testing.assert_array_equal(graded.doc_emb, jg.doc_emb)
    np.testing.assert_array_equal(graded.q_proj, jg.q_proj)
    assert graded.qrels == jg.qrels
    assert graded.binary_qrels == jg.binary_qrels
    assert graded.corpus.q_distractors == jg.corpus.q_distractors
    for key in ("terms", "weights_b", "weights_l"):
        np.testing.assert_array_equal(graded.queries()[key],
                                      jg.queries()[key])
    for side in ("bm25", "learned"):
        a, b = getattr(graded.corpus, side), getattr(jg.corpus, side)
        for f in ("indptr", "docids", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(
        _embed_queries_np(graded.q_proj, graded.corpus.queries,
                          graded.corpus.q_weights_l),
        jax_embed_np(jg.q_proj, jg.corpus.queries, jg.corpus.q_weights_l))


def test_default_corpus_rng_unchanged_by_graded_knobs():
    """The graded tier and boost scale must not perturb the seeded draw
    sequence at their defaults: pinned parity baselines depend on
    bit-identical corpora."""
    base = make_corpus("splade_like", n_docs=512, n_terms=256,
                       n_queries=4, seed=9)
    explicit = make_corpus("splade_like", n_docs=512, n_terms=256,
                           n_queries=4, seed=9, n_rel_partial=0,
                           rel_boost_scale=1.0)
    np.testing.assert_array_equal(base.learned.weights,
                                  explicit.learned.weights)
    np.testing.assert_array_equal(base.bm25.weights, explicit.bm25.weights)
    assert base.qrels == explicit.qrels
    assert base.qrels_graded == [{d: 2.0 for d in r} for r in base.qrels]


def test_graded_corpus_without_partials_is_make_corpus():
    """``make_graded_corpus(n_rel_partial=0, ...).corpus`` is the
    ``make_corpus`` corpus of the same arguments (what ``chip_smoke.py``
    relies on to add the dense side without changing its postings)."""
    kw = dict(n_docs=2048, n_terms=700, n_queries=8, n_q_terms=16,
              avg_doc_terms=16, seed=4)
    g = make_graded_corpus("splade_like", n_rel=4, n_rel_partial=0,
                           rel_boost_scale=1.0, dim=24, **kw)
    c = make_corpus("splade_like", **kw)
    for side in ("bm25", "learned"):
        a, b = getattr(g.corpus, side), getattr(c, side)
        for f in ("indptr", "docids", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("queries", "q_weights_b", "q_weights_l"):
        np.testing.assert_array_equal(getattr(g.corpus, f), getattr(c, f))
    assert g.corpus.qrels == c.qrels
    assert g.corpus.qrels_graded == c.qrels_graded
    assert g.corpus.q_distractors == c.q_distractors
    ma, mb = g.corpus.merged("scaled"), c.merged("scaled")
    for f in ("indptr", "docids", "w_b", "w_l"):
        np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))
    assert g.doc_emb.shape == (2048, 24) and g.q_proj.shape == (700, 24)


def test_planted_embeddings_separate_grades(graded):
    """Relevant docs must sit far above the noise floor in dense cosine,
    partials in between, and the planting must target the *query-time*
    embedding (the numpy twin of hybrid.embed_queries)."""
    q_emb = _embed_queries_np(graded.q_proj, graded.corpus.queries,
                              graded.corpus.q_weights_l)
    rel_cos, part_cos, noise_cos = [], [], []
    planted = set()
    for gains in graded.qrels:
        planted |= set(gains)
    for d in graded.corpus.q_distractors:
        planted |= d
    rng = np.random.default_rng(0)
    noise_docs = [d for d in rng.integers(0, 4096, 200) if d not in planted]
    for qi, gains in enumerate(graded.qrels):
        for d, g in gains.items():
            (rel_cos if g == 2.0 else part_cos).append(
                float(graded.doc_emb[d] @ q_emb[qi]))
        noise_cos.extend(float(graded.doc_emb[d] @ q_emb[qi])
                         for d in noise_docs[:10])
    assert np.mean(rel_cos) > np.mean(part_cos) > np.mean(noise_cos)
    assert np.mean(rel_cos) > 0.5
    assert abs(np.mean(noise_cos)) < 0.1


# -- TREC interchange ---------------------------------------------------------

def test_trec_round_trip(tmp_path, graded, hybrid):
    """write_run -> load_run -> evaluate gives the same metrics as the
    in-memory evaluation (integer docids survive the string round trip), and
    the port writes the same run file bytes as the reference."""
    r = Retriever.open(hybrid, twolevel.fast(), engine="cascade",
                       depth=100, device="cpu")
    resp = r.search(k=100, **graded.queries())
    direct = evaluate_ranking(resp.ids, graded.qrels)

    qids = [f"q{i}" for i in range(len(graded.qrels))]
    run_path, qrels_path = tmp_path / "run.txt", tmp_path / "qrels.txt"
    write_run(run_path, qids, resp.ids, resp.scores, tag="cascade")
    qrels_path.write_text("".join(
        f"{qid} 0 {d} {int(g)}\n"
        for qid, gains in zip(qids, graded.qrels)
        for d, g in sorted(gains.items())))
    via_files = evaluate_trec(run_path, qrels_path)
    for m in ("mrr@10", "ndcg@10", "recall@10", "recall@100"):
        assert via_files[m] == pytest.approx(direct[m], abs=1e-9)
    jax_write_run(tmp_path / "jax_run.txt", qids, resp.ids, resp.scores,
                  tag="cascade")
    assert run_path.read_bytes() == (tmp_path / "jax_run.txt").read_bytes()
    assert direct == jax_evaluate_ranking(resp.ids, graded.qrels)


def test_trec_loaders_edge_cases(tmp_path):
    qp = tmp_path / "qrels.txt"
    qp.write_text("q1 0 docA 2\nq1 0 docB 0\n\nq2 0 docA 1\n")
    qrels = load_qrels(qp)
    assert qrels.qids == ["q1", "q2"]
    # grade-0 lines are kept as judgments but carry no gain
    assert qrels.gains["q1"]["docB"] == 0.0
    assert qrels.graded(["q1", "q2", "q3"]) == [
        {qrels.doc_index["docA"]: 2.0}, {qrels.doc_index["docA"]: 1.0},
        {}]
    jqrels = jax_load_qrels(qp)
    assert (qrels.gains, qrels.doc_index) == (jqrels.gains,
                                              jqrels.doc_index)
    rp = tmp_path / "run.txt"
    rp.write_text("q1 Q0 docB 2 0.5 t\nq1 Q0 docNEW 1 0.9 t\n")
    qids, ids = load_run(rp, qrels, depth=4)
    assert qids == ["q1"]
    # rank column orders the row; unjudged docids get fresh indices
    assert ids[0].tolist() == [qrels.doc_index["docNEW"],
                               qrels.doc_index["docB"], -1, -1]
    jqids, jids = jax_load_run(rp, jqrels, depth=4)
    assert jqids == qids and jqrels.doc_index == qrels.doc_index
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == jids.dtype
    bad = tmp_path / "bad.txt"
    bad.write_text("q1 0 docA\n")
    with pytest.raises(ValueError, match="expected"):
        load_qrels(bad)
    with pytest.raises(ValueError, match="expected"):
        load_run(bad, qrels)


def test_evaluate_retriever_reports_quality_and_latency(graded, hybrid):
    row = evaluate_retriever(
        Retriever.open(hybrid, twolevel.fast(), engine="rrf", depth=100,
                       device="cpu"),
        graded.queries(), graded.qrels, k=100)
    assert row["engine"] == "rrf" and row["n_queries"] == 32
    assert row["mrt_ms"] > 0 and np.isfinite(row["p99_ms"])
    assert 0.0 < row["mrr@10"] <= 1.0
    assert row["recall@100"] >= row["recall@10"] - 1e-9


# -- the headline small-k claim -----------------------------------------------

# The reference's deterministic margins on the seed-0 corpus
TF_MISALIGNED = 3.0
DROP_MARGIN = 0.05
RECOVERY_TOL = 0.02


def test_small_k_guided_degradation_and_twolevel_recovery(graded, hybrid,
                                                          carried):
    safe = _mrr10(hybrid, graded, "batched",
                  twolevel.linear_combination(gamma=0.05), TF_MISALIGNED)
    gti = _mrr10(hybrid, graded, "batched", twolevel.gti(), TF_MISALIGNED)
    acc = _mrr10(hybrid, graded, "batched", twolevel.accurate(),
                 TF_MISALIGNED)
    # the claim: guided-only traversal measurably degrades MRR@10...
    assert safe - gti >= DROP_MARGIN, (safe, gti)
    # ...two-level pruning (beta=0) recovers within tolerance...
    assert safe - acc <= RECOVERY_TOL, (safe, acc)
    # ...and WITHOUT two-level pruning (stay on GTI) the recovery
    # criterion demonstrably fails: the inverted configuration.
    assert safe - gti > RECOVERY_TOL, (safe, gti)
    jg, jh, _ = carried
    assert (safe, gti, acc) == tuple(
        _jax_mrr10(jh, jg, "batched", p, TF_MISALIGNED)
        for p in (jax_twolevel.linear_combination(gamma=0.05),
                  jax_twolevel.gti(), jax_twolevel.accurate()))


def test_small_k_cascade_recovers_guided_loss(graded, hybrid, carried):
    """The hybrid second stage recovers what guided pruning lost: at the
    misaligned operating point, cascade MRR@10 beats sparse GTI by more
    than the guided drop itself."""
    gti = _mrr10(hybrid, graded, "batched", twolevel.gti(), TF_MISALIGNED)
    casc = _mrr10(hybrid, graded, "cascade", twolevel.gti(),
                  TF_MISALIGNED, depth=100)
    rrf = _mrr10(hybrid, graded, "rrf", twolevel.gti(), TF_MISALIGNED,
                 depth=100)
    assert casc >= gti + DROP_MARGIN, (casc, gti)
    assert rrf >= gti + DROP_MARGIN, (rrf, gti)
    jg, jh, _ = carried
    assert (casc, rrf) == tuple(
        _jax_mrr10(jh, jg, e, jax_twolevel.gti(), TF_MISALIGNED, depth=100)
        for e in ("cascade", "rrf"))


# -- quality_bench's grid, lane for lane -----------------------------------------

# benchmarks/quality_bench.py's METHODS, THRESHOLD_FACTORS and ENGINES
METHODS = {"rank_safe": (lambda m: m.linear_combination(gamma=0.05)),
           "gti": (lambda m: m.gti()), "2gti_fast": (lambda m: m.fast())}
ENGINES = {"sparse": ("batched", {}), "cascade": ("cascade", {"depth": 100}),
           "rrf": ("rrf", {"depth": 100})}


@pytest.mark.parametrize("lane", sorted(ENGINES))
@pytest.mark.parametrize("tf", [1.0, 3.0])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_quality_bench_lane_matches_reference(carried, method, tf, lane):
    """One (method, threshold_factor, engine) lane: the rankings at the
    bench's k=100 and its headline k=10 give the same ``evaluate_ranking``
    numbers on the port as on the reference."""
    jg, jh, th = carried
    engine, opts = ENGINES[lane]
    jr = JaxRetriever.open(jh, METHODS[method](jax_twolevel),
                           engine=engine, **opts)
    tr = Retriever.open(th, METHODS[method](twolevel), engine=engine,
                        device="cpu", **opts)
    for k in (100, 10):
        want = jr.search(k=k, threshold_factor=tf, **jg.queries())
        got = tr.search(k=k, threshold_factor=tf, **jg.queries())
        np.testing.assert_array_equal(got.ids, want.ids)
        assert (evaluate_ranking(got.ids, jg.qrels)
                == jax_evaluate_ranking(want.ids, jg.qrels))


def test_quality_bench_dense_and_frontier_match_reference(carried):
    """The dense-only lane (exact top-100 through the query bridge) and
    the cascade depth frontier (k' 20/50/100/200 under ``fast()``)."""
    jg, jh, th = carried
    q = jg.queries()
    _, want = jhy.dense_topk(
        jh, jhy.embed_queries(jh, q["terms"], q["weights_l"]), k=100)
    _, got = dense_topk(th, embed_queries(th, q["terms"], q["weights_l"]),
                        k=100)
    np.testing.assert_array_equal(got, want)
    assert (evaluate_ranking(got, jg.qrels)
            == jax_evaluate_ranking(want, jg.qrels))
    for depth in (20, 50, 100, 200):
        want = JaxRetriever.open(jh, jax_twolevel.fast(), engine="cascade",
                                 depth=depth).search(k=100, **q)
        got = Retriever.open(th, twolevel.fast(), engine="cascade",
                             depth=depth, device="cpu").search(k=100, **q)
        np.testing.assert_array_equal(got.ids, want.ids)
        assert (evaluate_ranking(got.ids, jg.qrels)
                == jax_evaluate_ranking(want.ids, jg.qrels))
