"""Deterministic, resume-safe data streams: every batch is a pure function
of (seed, step) — a restart replays exactly the unapplied batches.

The port of ``repro.data.stream``: numpy draws in the reference's order, so
the batches are bit-identical to its own, returned as int32 / float32
tensors on an explicit ``device`` (``GraphStore.sample`` returns numpy
arrays, as the reference's does)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.index import resolve_device


def to_device(device, **arrays) -> dict:
    """Each array as a tensor on ``device``: integers int32, floats
    float32 (the reference's dtypes without 64-bit mode)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(
        a, np.int32 if np.asarray(a).dtype.kind in "iu" else np.float32),
        device=dev) for k, a in arrays.items()}



def lm_batch(step: int, *, batch: int, seq: int, vocab: int, seed: int = 0,
             zipf_a: float = 1.2, device="cuda") -> dict:
    """Zipf-distributed synthetic token stream (LM pretraining proxy)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ranks = rng.zipf(zipf_a, size=(batch, seq + 1))
    toks = np.minimum(ranks, vocab - 1).astype(np.int32)
    return to_device(device, tokens=toks[:, :-1], targets=toks[:, 1:])


def pair_batch(step: int, *, batch: int, seq: int, vocab: int,
               n_rel_terms: int = 4, seed: int = 0, device="cuda") -> dict:
    """(query, positive doc) pairs for sparse-encoder distillation: docs
    share salient terms with their query; teacher score = overlap count."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 1]))
    salient = rng.integers(1, vocab, size=(batch, n_rel_terms))
    q = np.concatenate([salient, rng.integers(1, vocab,
                                              (batch, seq - n_rel_terms))], 1)
    d_pos = np.concatenate([salient, rng.integers(1, vocab,
                                                  (batch, seq - n_rel_terms))],
                           1)
    d_neg = rng.integers(1, vocab, size=(batch, seq))
    return to_device(device, query=q, doc_pos=d_pos, doc_neg=d_neg)


def recsys_batch(step: int, *, kind: str, cfg, batch: int, seed: int = 0,
                 device="cuda") -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 2]))
    if kind == "dlrm":
        return to_device(device,
                         dense=rng.standard_normal((batch, cfg.n_dense)),
                         sparse=rng.integers(
                             0, cfg.vocab_per_field,
                             (batch, cfg.n_sparse, cfg.multi_hot)),
                         label=rng.integers(0, 2, batch))
    if kind == "din":
        return to_device(device,
                         hist=rng.integers(0, cfg.n_items,
                                           (batch, cfg.seq_len)),
                         target=rng.integers(0, cfg.n_items, batch),
                         label=rng.integers(0, 2, batch))
    raise ValueError(kind)


class GraphStore:
    """CSR adjacency + real fanout neighbor sampler (minibatch_lg cell)."""

    def __init__(self, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        # power-law-ish degree distribution
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        dst = np.minimum((rng.pareto(1.5, n_edges) * n_nodes / 8),
                         n_nodes - 1).astype(np.int32)
        order = np.argsort(dst, kind="stable")
        self.src, self.dst = src[order], dst[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(self.dst, minlength=n_nodes),
                  out=self.indptr[1:])
        self.n_nodes, self.d_feat, self.n_classes = n_nodes, d_feat, n_classes
        self.feat_seed = seed

    def features(self, nodes: np.ndarray) -> np.ndarray:
        """Deterministic per-node features (hash-seeded)."""
        rng = np.random.default_rng(self.feat_seed)
        base = rng.standard_normal((256, self.d_feat)).astype(np.float32)
        return base[nodes % 256] + (nodes % 7)[:, None] * 0.01

    def labels(self, nodes: np.ndarray) -> np.ndarray:
        return (nodes % self.n_classes).astype(np.int32)

    def sample(self, step: int, batch_nodes: int, fanouts=(15, 10),
               seed: int = 0) -> dict:
        """k-hop uniform neighbor sampling -> padded subgraph arrays."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 3]))
        seeds = rng.choice(self.n_nodes, batch_nodes, replace=False)
        nodes = [seeds]
        edges_src, edges_dst = [], []
        frontier = seeds
        for fan in fanouts:
            nbr_src = []
            nbr_dst = []
            for v in frontier:
                s, e = self.indptr[v], self.indptr[v + 1]
                if e > s:
                    pick = self.src[rng.integers(s, e, size=fan)]
                else:
                    pick = np.full(fan, v, np.int32)
                nbr_src.append(pick)
                nbr_dst.append(np.full(fan, v, np.int32))
            frontier = np.concatenate(nbr_src)
            edges_src.append(frontier)
            edges_dst.append(np.concatenate(nbr_dst))
            nodes.append(frontier)
        all_nodes, inv = np.unique(np.concatenate(nodes),
                                   return_inverse=False), None
        del inv
        remap = {v: i for i, v in enumerate(all_nodes)}
        es = np.array([remap[v] for v in np.concatenate(edges_src)],
                      np.int32)
        ed = np.array([remap[v] for v in np.concatenate(edges_dst)],
                      np.int32)
        deg = np.maximum(self.indptr[all_nodes + 1] - self.indptr[all_nodes],
                         1)
        dist_nodes = 1.0 + 9.0 / np.sqrt(deg)
        edge_dist = ((dist_nodes[es] + dist_nodes[ed]) / 2).astype(np.float32)
        mask = np.zeros(len(all_nodes), np.float32)
        mask[[remap[v] for v in seeds]] = 1.0
        return {"x": self.features(all_nodes),
                "edge_src": es, "edge_dst": ed, "edge_dist": edge_dist,
                "labels": self.labels(all_nodes), "train_mask": mask}


def molecule_batch(step: int, *, batch: int, atoms: int, edges: int,
                   n_types: int, seed: int = 0, device="cuda") -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 4]))
    z = rng.integers(1, n_types, (batch, atoms)).astype(np.int32)
    pos = rng.standard_normal((batch, atoms, 3)).astype(np.float32) * 2
    es = rng.integers(0, atoms, (batch, edges)).astype(np.int32)
    ed = rng.integers(0, atoms, (batch, edges)).astype(np.int32)
    # synthetic energy: pairwise potential proxy so the model can learn
    d = np.linalg.norm(pos[np.arange(batch)[:, None], es]
                       - pos[np.arange(batch)[:, None], ed], axis=-1)
    energy = (np.exp(-d) - 0.1 * d).sum(1).astype(np.float32)
    return to_device(device, z=z, pos=pos, edge_src=es, edge_dst=ed,
                     energy=energy)
