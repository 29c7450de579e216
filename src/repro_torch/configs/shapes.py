"""The shape cells of the LM, GNN and recsys families, as plain dicts.

``kind`` says which step a cell runs (train, prefill, decode, serve,
retrieval; the GNN's gnn_full, gnn_sampled and gnn_mol are train cells);
the sizes are the full cells' batch, sequence, shortlist and candidate
counts, and the graphs' node, edge, feature and class counts.
"""
from __future__ import annotations

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
