"""Public search API over the 2GTI traversal engines.

  - :mod:`contract`: ``SearchRequest`` / ``SearchResponse`` with per-call
    ``k`` and ``threshold_factor``; ``K_BUCKETS`` depth buckets;
  - :mod:`engines`: the ``Engine`` protocol and string-keyed registry
    (``batched`` / ``kernel`` / ``sequential`` / ``sharded`` / ``dense``
    plus the hybrid ``cascade`` / ``rrf``);
  - :mod:`hybrid`: the sparse+dense substrate (``HybridIndex``,
    ``build_hybrid_index``, the query embedding bridge, the dense rerank,
    ``dense_topk``, ``rrf_fuse``) the hybrid engines run on;
  - :mod:`retriever`: the ``Retriever`` facade
    (``Retriever.open(index, params, engine=..., device=...)`` →
    ``.search(...)``) handling padding, k-bucketing and engine dispatch.
"""
from .contract import (K_BUCKETS, SearchRequest, SearchResponse,  # noqa: F401
                       bucket_k, resolve_ks)
from .engines import (Engine, engine_names, get_engine,  # noqa: F401
                      register_engine)
from .hybrid import (HybridIndex, build_hybrid_index,  # noqa: F401
                     dense_topk, embed_queries, rerank_candidates,
                     rrf_fuse)
from .retriever import Retriever  # noqa: F401
