"""The shape cells of the LM and recsys families, as plain dicts.

``kind`` says which step a cell runs (train, prefill, decode, serve,
retrieval); the sizes are the full cells' batch, sequence, shortlist and
candidate counts.
"""
from __future__ import annotations

LM_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RECSYS_SHAPE_DEFS = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512, shortlist=8192),
    "serve_bulk": dict(kind="serve", batch=262144, shortlist=8192),
    # 1M candidates padded to a 512 multiple so the candidate axis
    # shards evenly over 256/512 devices (pad scores are masked).
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_448),
}
