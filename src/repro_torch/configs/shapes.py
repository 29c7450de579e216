"""The shape cells of the LM, GNN and recsys families, and
``input_specs()``: stand-ins for every (arch x shape) cell's inputs.

The ``*_SHAPE_DEFS`` dicts say, per cell, which step it runs (``kind``:
train, prefill, decode, serve, retrieval; the GNN's gnn_full, gnn_sampled
and gnn_mol are train cells) and its sizes: batch, sequence, shortlist and
candidate counts, and the graphs' node, edge, feature and class counts.

The port of ``repro.configs.shapes``. ``input_specs`` returns the
reference's dicts (``kind``, ``max_len``, ``classes``, ``d_feat``,
``inputs``) with meta tensors in place of ``ShapeDtypeStruct``s: shapes
and dtypes, no storage, nothing allocated. The dry run
(``launch/dryrun.py``) places them on a mesh.
"""
from __future__ import annotations

import torch

I32 = torch.int32
F32 = torch.float32


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m

LM_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

GNN_SHAPE_DEFS = {
    # (nodes, edges, d_feat, n_classes, replicate)
    "full_graph_sm": dict(kind="gnn_full", nodes=2708, edges=10556,
                          d_feat=1433, classes=7, pad=1),  # replicated
    # Reddit-scale sampled training: 1024 seeds x fanout 15 -> x10
    "minibatch_lg": dict(kind="gnn_sampled", nodes=169984, edges=168960,
                         d_feat=602, classes=41, pad=512),
    "ogb_products": dict(kind="gnn_full", nodes=2449029, edges=61859140,
                         d_feat=100, classes=47, pad=512),
    "molecule": dict(kind="gnn_mol", batch=128, atoms=30, edges=64),
}

RECSYS_SHAPE_DEFS = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512, shortlist=8192),
    "serve_bulk": dict(kind="serve", batch=262144, shortlist=8192),
    # 1M candidates padded to a 512 multiple so the candidate axis
    # shards evenly over 256/512 devices (pad scores are masked).
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_448),
}


def lm_input_specs(cfg, shape: str) -> dict:
    d = LM_SHAPE_DEFS[shape]
    b, s = d["batch"], d["seq"]
    kind = d["kind"]
    if kind == "train":
        return {"kind": kind,
                "inputs": {"batch": {"tokens": _spec((b, s), I32),
                                     "targets": _spec((b, s), I32)}}}
    if kind == "prefill":
        return {"kind": kind, "max_len": s,
                "inputs": {"tokens": _spec((b, s), I32)}}
    # decode: one new token against a seq-length KV cache
    hkv, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    quant = getattr(cfg, "kv_quant", False)
    kv_dtype = torch.int8 if quant else cfg.compute_dtype
    cache = {"k": _spec((n, b, s, hkv, dh), kv_dtype),
             "v": _spec((n, b, s, hkv, dh), kv_dtype)}
    if quant:
        cache["k_scale"] = _spec((n, b, s, hkv), F32)
        cache["v_scale"] = _spec((n, b, s, hkv), F32)
    return {"kind": "decode",
            "inputs": {"token": _spec((b, 1), I32), "cache": cache,
                       "cache_len": _spec((), I32)}}


def gnn_input_specs(cfg, shape: str) -> dict:
    d = GNN_SHAPE_DEFS[shape]
    if d["kind"] == "gnn_mol":
        b, n, e = d["batch"], d["atoms"], d["edges"]
        return {"kind": "gnn_mol",
                "inputs": {"batch": {
                    "z": _spec((b, n), I32), "pos": _spec((b, n, 3), F32),
                    "edge_src": _spec((b, e), I32),
                    "edge_dst": _spec((b, e), I32),
                    "energy": _spec((b,), F32)}}}
    nn, ee = _pad_to(d["nodes"], d["pad"]), _pad_to(d["edges"], d["pad"])
    return {"kind": d["kind"], "classes": d["classes"], "d_feat": d["d_feat"],
            "inputs": {"batch": {
                "x": _spec((nn, d["d_feat"]), F32),
                "edge_src": _spec((ee,), I32), "edge_dst": _spec((ee,), I32),
                "edge_dist": _spec((ee,), F32),
                "labels": _spec((nn,), I32),
                "train_mask": _spec((nn,), F32)}}}


def recsys_input_specs(cfg, shape: str) -> dict:
    from ..models.recsys import (Bert4RecConfig, DINConfig, DLRMConfig,
                                 TwoTowerConfig)
    d = RECSYS_SHAPE_DEFS[shape]
    b = d["batch"]
    if isinstance(cfg, DLRMConfig):
        feats = {"dense": _spec((b, cfg.n_dense), F32),
                 "sparse": _spec((b, cfg.n_sparse, cfg.multi_hot), I32)}
        if d["kind"] == "train":
            return {"kind": "train",
                    "inputs": {"batch": {**feats, "label": _spec((b,), I32)}}}
        if d["kind"] == "serve":
            return {"kind": "serve", "inputs": {"batch": feats}}
        # retrieval: user context + 1M candidate ids for the varying field
        user = {"dense": _spec((1, cfg.n_dense), F32),
                "sparse": _spec((1, cfg.n_sparse - 1, cfg.multi_hot), I32)}
        return {"kind": "retrieval",
                "inputs": {"user": user,
                           "cand_ids": _spec((d["n_cand"],), I32)}}
    if isinstance(cfg, DINConfig):
        if d["kind"] == "train":
            return {"kind": "train", "inputs": {"batch": {
                "hist": _spec((b, cfg.seq_len), I32),
                "target": _spec((b,), I32), "label": _spec((b,), I32)}}}
        if d["kind"] == "serve":
            return {"kind": "serve", "inputs": {"batch": {
                "hist": _spec((b, cfg.seq_len), I32),
                "target": _spec((b,), I32)}}}
        return {"kind": "retrieval",
                "inputs": {"hist": _spec((1, cfg.seq_len), I32),
                           "cand_ids": _spec((d["n_cand"],), I32)}}
    if isinstance(cfg, TwoTowerConfig):
        if d["kind"] == "train":
            return {"kind": "train", "inputs": {"batch": {
                "user_feats": _spec((b, cfg.user_bag), I32),
                "pos_item": _spec((b,), I32),
                "neg_items": _spec((cfg.n_negatives,), I32),
                "neg_logq": _spec((cfg.n_negatives,), F32)}}}
        if d["kind"] == "serve":
            return {"kind": "serve", "inputs": {
                "user_feats": _spec((b, cfg.user_bag), I32),
                "shortlist": _spec((d["shortlist"],), I32)}}
        # retrieval: 1 user vs 1M precomputed candidate tower outputs
        return {"kind": "retrieval",
                "inputs": {"user_feats": _spec((1, cfg.user_bag), I32),
                           "cand_emb": _spec((d["n_cand"],
                                              cfg.tower_mlp[-1]), F32)}}
    if isinstance(cfg, Bert4RecConfig):
        if d["kind"] == "train":
            return {"kind": "train", "inputs": {"batch": {
                "items": _spec((b, cfg.seq_len), I32),
                "targets": _spec((b, cfg.seq_len), I32),
                "mask": _spec((b, cfg.seq_len), I32),
                "neg_items": _spec((512,), I32)}}}
        if d["kind"] == "serve":
            return {"kind": "serve", "inputs": {
                "items": _spec((b, cfg.seq_len), I32),
                "cand_ids": _spec((d["shortlist"],), I32)}}
        return {"kind": "retrieval",
                "inputs": {"items": _spec((1, cfg.seq_len), I32),
                           "cand_ids": _spec((d["n_cand"],), I32)}}
    raise TypeError(f"unknown recsys config {type(cfg)}")


def input_specs(arch, shape: str, cfg=None) -> dict:
    """Dispatch by family. ``arch``: ArchSpec; returns the spec dict."""
    cfg = cfg if cfg is not None else arch.config()
    if arch.family == "lm":
        return lm_input_specs(cfg, shape)
    if arch.family == "gnn":
        return gnn_input_specs(cfg, shape)
    if arch.family == "recsys":
        return recsys_input_specs(cfg, shape)
    raise ValueError(arch.family)
