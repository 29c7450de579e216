"""End-to-end driver: train a SPLADE-style learned sparse encoder, then
serve its index with 2GTI — the full pipeline the paper sits inside.

    PYTHONPATH=src python -m repro_torch.launch.train_sparse_encoder --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_sparse_encoder --full

The port of the JAX package's ``examples/train_sparse_encoder.py``, with
its steps, sizes, flags and printout:

  1. Train a bidirectional transformer encoder with the SPLADE head
     (log1p-relu-maxpool over vocab) on synthetic (query, doc+, doc-)
     pairs: InfoNCE with in-batch negatives + FLOP regularization, through
     the fault-tolerant ``Trainer`` (crash-safe checkpoints, auto-resume).
     The loss differentiates through ``scores_attention``.
  2. Encode a document collection into a learned sparse index (under
     ``torch.no_grad()``, through the flash-attention kernel on the card);
     build the BM25 index from raw term counts; merge (scaled fill).
  3. Retrieve with MaxScore-org vs 2GTI and report relevance + latency.

Defaults are the small configuration (~7M params); ``--full`` selects the
~100M-parameter one. ``--device`` (default ``cuda``) holds the model, the
index and every search.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import build_index, merge_models, twolevel
from ..core.bm25 import build_bm25
from ..core.metrics import evaluate_run, mean_and_p99
from ..core.sparse import from_coo
from ..data.stream import pair_batch
from ..models.transformer import (TransformerConfig, init_params,
                                  scores_attention, splade_encode)
from ..retrieval import Retriever
from ..train.optimizer import AdamWConfig, flop_regularizer
from ..train.trainer import Trainer, TrainerConfig

VOCAB = 4096
SEQ = 48
N_DOCS, N_QUERIES, N_Q_TERMS = 1024, 32, 12
PRESETS = (("MaxScore-org", twolevel.original()),
           ("2GTI-Fast", twolevel.fast().replace(schedule="impact")))


def encoder_config(full: bool) -> TransformerConfig:
    if full:
        return TransformerConfig(n_layers=12, d_model=768, n_heads=12,
                                 n_kv_heads=12, d_ff=3072, vocab=30522,
                                 causal=False, rope=False, max_position=128,
                                 sparse_head=True, remat=False,
                                 compute_dtype=torch.float32)
    return TransformerConfig(n_layers=4, d_model=256, n_heads=4,
                             n_kv_heads=4, d_ff=512, vocab=VOCAB,
                             causal=False, rope=False, max_position=SEQ,
                             sparse_head=True, remat=False,
                             compute_dtype=torch.float32)


def make_loss(cfg, flop_weight=3e-4):
    def loss_fn(params, batch):
        def enc(tokens):
            return splade_encode(cfg, params, tokens, torch.ones_like(tokens),
                                 attention=scores_attention)
        rq = enc(batch["query"])
        docs = torch.cat([enc(batch["doc_pos"]), enc(batch["doc_neg"])],
                         dim=0)                       # [2B, V]
        logits = rq @ docs.T / 10.0                   # in-batch negatives
        labels = torch.arange(rq.shape[0], device=rq.device)
        logp = torch.log_softmax(logits, dim=-1)
        nce = -torch.gather(logp, -1, labels[:, None]).mean()
        reg = flop_regularizer(rq) + flop_regularizer(docs)
        return nce + flop_weight * reg
    return loss_fn


def make_trainer(cfg, steps, batch, out, device, ckpt_every=50,
                 fail_at_step=None) -> Trainer:
    """The example's Trainer: pair batches of ``batch`` x SEQ tokens on
    ``device``, AdamW at 3e-4 with 20 warmup steps."""
    return Trainer(
        make_loss(cfg),
        lambda seed: init_params(cfg, torch.Generator(device=device)
                                 .manual_seed(int(seed))),
        lambda step: pair_batch(step, batch=batch, seq=SEQ,
                                vocab=cfg.vocab, device=device),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                      out_dir=out, log_every=10, fail_at_step=fail_at_step),
        AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps))


@torch.no_grad()
def encode(cfg, params, tokens: np.ndarray, device) -> np.ndarray:
    """SPLADE reps [n, vocab] of token rows, through the kernel."""
    t = torch.as_tensor(tokens, device=device)
    return splade_encode(cfg, params, t, torch.ones_like(t)).cpu().numpy()


def learned_model(rep: np.ndarray, threshold=0.03):
    """The learned SparseModel of reps [n_docs, vocab]: the weights above
    ``threshold``."""
    d, t = np.nonzero(rep > threshold)
    return from_coo(rep.shape[0], rep.shape[1], t, d,
                    rep[d, t].astype(np.float32))


def encode_collection(cfg, params, token_mat, device, batch=32,
                      threshold=0.03):
    """Encode docs -> learned SparseModel (top weights above threshold)."""
    rep = np.concatenate([encode(cfg, params, token_mat[i:i + batch], device)
                          for i in range(0, len(token_mat), batch)], axis=0)
    return learned_model(rep, threshold), rep


def eval_collection(vocab: int):
    """The example's eval collection: docs share salient terms with their
    query. Returns (docs, queries, qrels)."""
    rng = np.random.default_rng(7)
    docs = rng.integers(1, vocab, (N_DOCS, SEQ)).astype(np.int32)
    queries = np.zeros((N_QUERIES, SEQ), np.int32)
    qrels = []
    for qi in range(N_QUERIES):
        rel = qi * (N_DOCS // N_QUERIES)
        queries[qi, :6] = docs[rel, :6]
        queries[qi, 6:] = rng.integers(1, vocab, SEQ - 6)
        qrels.append({int(rel)})
    return docs, queries, qrels


def merged_index(learned, docs, vocab, device):
    """BM25 from the raw term counts of the same docs, merged with the
    learned model (scaled fill), as a BII of 256-doc tiles on ``device``."""
    n_docs = len(docs)
    terms = docs.ravel().astype(np.int64)
    docids = np.repeat(np.arange(n_docs, dtype=np.int64), SEQ)
    tfs = np.ones_like(terms)
    lens = np.full(n_docs, float(SEQ), np.float32)
    bm25, _ = build_bm25(n_docs, vocab, terms, docids, tfs, lens)
    return build_index(merge_models(learned, bm25, "scaled"), tile_size=256,
                       device=device)


def query_terms(q_reps: np.ndarray):
    """Each query's N_Q_TERMS heaviest vocab entries: (terms, weights_b,
    weights_l), the BM25 side weighted 1."""
    n_q = len(q_reps)
    q_terms = np.zeros((n_q, N_Q_TERMS), np.int32)
    q_wl = np.zeros((n_q, N_Q_TERMS), np.float32)
    for qi in range(n_q):
        top = np.argsort(-q_reps[qi])[:N_Q_TERMS]
        q_terms[qi] = top
        q_wl[qi] = q_reps[qi, top]
    return q_terms, np.ones_like(q_wl), q_wl


def main(argv=None) -> dict:
    """Run the pipeline on ``argv`` (default: the command line); returns
    the trained params, the index, the query terms and each preset's
    response and quality, after printing the example's lines."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train_sparse_encoder")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default="runs/sparse_encoder")
    ap.add_argument("--device", default="cuda",
                    help="where the model, index and searches run")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available (pass "
                 f"--device cpu to run on the CPU)")

    cfg = encoder_config(args.full)
    print(f"encoder: {cfg.param_count()/1e6:.1f}M params, vocab {cfg.vocab}")
    trainer = make_trainer(cfg, args.steps, args.batch, args.out, dev)
    t0 = time.time()
    res = trainer.run()
    print(f"trained {args.steps} steps in {time.time()-t0:.0f}s; "
          f"loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f}")
    params = res["state"]["params"]

    docs, queries, qrels = eval_collection(cfg.vocab)
    learned, _ = encode_collection(cfg, params, docs, dev)
    print(f"learned index: {learned.nnz} postings "
          f"({learned.nnz/len(docs):.0f}/doc)")
    index = merged_index(learned, docs, cfg.vocab, dev)
    q_terms, q_wb, q_wl = query_terms(encode(cfg, params, queries, dev))

    runs = {}
    for name, p in PRESETS:
        r = Retriever.open(index, p, engine="sequential", device=dev)
        resp = r.search(terms=q_terms, weights_b=q_wb, weights_l=q_wl, k=10)
        m = evaluate_run(resp.ids, qrels, 10)
        mrt, p99 = mean_and_p99(resp.latencies_ms)
        print(f"{name:14s} MRR@10={m['mrr']:.3f} R@10={m['recall']:.3f} "
              f"MRT={mrt:.1f}ms P99={p99:.1f}ms")
        runs[name] = {"response": resp, "mrr@10": m["mrr"],
                      "r@10": m["recall"], "mrt_ms": mrt, "p99_ms": p99}
    return {"losses": res["losses"], "params": params, "index": index,
            "queries": (q_terms, q_wb, q_wl), "qrels": qrels, "runs": runs}


if __name__ == "__main__":
    main()
