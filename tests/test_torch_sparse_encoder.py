"""The port's sparse-encoder pipeline
(``repro_torch.launch.train_sparse_encoder``) against the JAX package's
``examples/train_sparse_encoder.py``, at the example's small
configuration (4 layers, d 256, vocab 4096), on the CPU.

- Training: 5 Trainer steps on ``pair_batch`` from the reference's
  initial parameters (carried by the bridge): losses within rtol 1e-4
  (three encodes, a softmax over in-batch negatives and the FLOP
  regularizer sum in other orders).
- Encoding: the port's ``encode`` (the flash-attention kernel's plain
  version here) of the reference's trained parameters within 1e-4 of the
  reference's reps.
- Index and search: from the reference's encoded reps, the port's merged
  index equals the reference's array for array, and the ``sequential``
  engine returns the reference's ids under MaxScore-org and 2GTI-Fast,
  and so does the ``kernel`` engine at ``chunked_fused`` and ``chunked``
  (the guided preset's chunk-start thresholds may prune ``chunked_fused``
  otherwise than the sequential engine, in both packages alike).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as JCORE
from repro.data.stream import pair_batch as j_pair_batch
from repro.models import transformer as J
from repro.retrieval import Retriever as JRetriever
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch import bridge
from repro_torch.launch import train_sparse_encoder as TSE
from repro_torch.retrieval import Retriever

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 5


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "train_sparse_encoder_example",
        ROOT / "examples" / "train_sparse_encoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(example, tmp_path_factory):
    """Both packages' Trainer runs of STEPS steps from the reference's
    initial parameters."""
    tmp = tmp_path_factory.mktemp("enc")
    jcfg, cfg = example.encoder_config(False), TSE.encoder_config(False)
    jparams0 = J.init_params(jcfg, jax.random.PRNGKey(0))
    arrays = jax.tree_util.tree_map(np.asarray, jparams0)
    ref = JT.Trainer(
        example.make_loss(jcfg), lambda key: J.init_params(jcfg, key),
        lambda step: j_pair_batch(step, batch=8, seq=example.SEQ,
                                  vocab=jcfg.vocab),
        JT.TrainerConfig(total_steps=STEPS, ckpt_every=50,
                         out_dir=str(tmp / "ref"), log_every=10),
        JO.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=STEPS)).run()
    trainer = TSE.make_trainer(cfg, STEPS, 8, str(tmp / "port"), "cpu")
    trainer._init_params = lambda seed: bridge.transformer_params_from_arrays(
        cfg, arrays, "cpu")
    port = trainer.run()
    return jcfg, cfg, ref, port


def test_training_losses_match_reference(trained):
    _, _, ref, port = trained
    assert len(port["losses"]) == STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)


def test_config_matches_example(example):
    for full in (False, True):
        a, b = example.encoder_config(full), TSE.encoder_config(full)
        for f in dataclasses.fields(b):
            if f.name not in ("compute_dtype", "param_dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.param_count() == b.param_count()


@pytest.fixture(scope="module")
def reps(example, trained):
    """The reference's reps of the eval collection (its trained params)."""
    jcfg, cfg, ref, _ = trained
    docs, queries, qrels = TSE.eval_collection(jcfg.vocab)
    jparams = ref["state"]["params"]
    _, rep = example.encode_collection(jcfg, jparams, docs)
    q = jnp.asarray(queries)
    q_rep = np.asarray(J.splade_encode(jcfg, jparams, q, jnp.ones_like(q)))
    params = bridge.transformer_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return docs, queries, qrels, rep, q_rep, params


def test_encode_matches_reference(reps, trained):
    docs, queries, _, rep, q_rep, params = reps
    cfg = trained[1]
    np.testing.assert_allclose(TSE.encode(cfg, params, docs[:64], "cpu"),
                               rep[:64], rtol=0, atol=1e-4)
    np.testing.assert_allclose(TSE.encode(cfg, params, queries, "cpu"),
                               q_rep, rtol=0, atol=1e-4)


def test_index_and_ids_match_reference(reps, trained):
    """From the reference's reps: the same merged index, and the
    reference's ids through the example's engine and the kernel engine's
    traversals under both presets."""
    docs, _, _, rep, q_rep, _ = reps
    vocab = trained[0].vocab
    index = TSE.merged_index(TSE.learned_model(rep), docs, vocab, "cpu")
    # the example's own index build
    d, t = np.nonzero(rep > 0.03)
    learned = JCORE.sparse.from_coo(rep.shape[0], vocab, t, d,
                                    rep[d, t].astype(np.float32))
    terms = docs.ravel().astype(np.int64)
    docids = np.repeat(np.arange(len(docs), dtype=np.int64), docs.shape[1])
    bm25, _ = JCORE.build_bm25(len(docs), vocab, terms, docids,
                               np.ones_like(terms),
                               np.full(len(docs), float(docs.shape[1]),
                                       np.float32))
    jindex = JCORE.build_index(JCORE.merge_models(learned, bm25, "scaled"),
                               tile_size=256)
    for f in ("docids", "w_b", "w_l", "tile_ptr", "tile_max_b",
              "tile_max_l"):
        np.testing.assert_array_equal(getattr(index, f).numpy(),
                                      np.asarray(getattr(jindex, f)), f)
    q_terms, q_wb, q_wl = TSE.query_terms(q_rep)
    # the example's own query terms
    for qi in range(len(q_rep)):
        top = np.argsort(-q_rep[qi])[:12]
        np.testing.assert_array_equal(q_terms[qi], top)
        np.testing.assert_array_equal(q_wl[qi], q_rep[qi, top])
    q = dict(terms=q_terms, weights_b=q_wb, weights_l=q_wl, k=10)
    for name, p in TSE.PRESETS:
        want = JRetriever.open(jindex, p, engine="sequential").search(**q)
        got = Retriever.open(index, p, engine="sequential",
                             device="cpu").search(**q)
        np.testing.assert_array_equal(got.ids, np.asarray(want.ids), name)
        for traversal in ("chunked_fused", "chunked"):
            kern = Retriever.open(index, p, engine="kernel", device="cpu",
                                  traversal=traversal).search(**q)
            jkern = JRetriever.open(jindex, p, engine="kernel",
                                    traversal=traversal).search(**q)
            np.testing.assert_array_equal(kern.ids, np.asarray(jkern.ids),
                                          f"{name} {traversal}")
