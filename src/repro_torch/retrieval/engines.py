"""Engine protocol + string-keyed registry of retrieval backends.

Every engine adapts one traversal entry point to the uniform
``search(terms, weights_b, weights_l, dense, *, k, params)`` contract and
returns a ``core.traversal.RetrievalResult``. All engines are driven by the
same ``core.plan`` planner; registering an engine selects an executor,
never a different pruning algorithm:

    "batched"     batched tile scan, plain torch scorer
    "kernel"      same scan, guided_score CUDA kernels on a GPU index
                  (their decode-in-kernel ``_q`` twins on a compressed one)
    "sequential"  host tile loop, physical skips + timings
    "sharded"     tile ranges scanned per shard + stable top-k merge:
                  emulated on one device, or one rank per shard in a
                  torch.distributed group (``serve.sharded``)
    "dense"       blocked dense two-level pruning (``core.dense_guided``)
    "cascade"     sparse traversal at depth k' -> dense rerank to k
    "rrf"         reciprocal-rank fusion of sparse + dense rankings

The hybrid engines (``cascade`` / ``rrf``) open on a
:class:`~repro_torch.retrieval.hybrid.HybridIndex` (sparse index + dense doc
embeddings + query projection); every *sparse* engine also accepts a
HybridIndex and serves its ``.sparse`` side, and ``dense`` its ``.dense``
side, so one scheduler index can back a routing policy that mixes sparse
and hybrid routes.

Third-party backends register with ``@register_engine("name")``; the class
must accept ``(index, params, device=..., **opts)`` and implement
``search``.
"""
from __future__ import annotations

import copy
from typing import Protocol, runtime_checkable

import numpy as np

from ..core.dense_guided import DenseGuidedIndex, retrieve_dense_batched
from ..core.index import BlockedImpactIndex
from ..core.traversal import (RetrievalResult, retrieve_batched,
                              retrieve_sequential)
from ..core.twolevel import TwoLevelParams
from ..index.compressed import CompressedImpactIndex
from .contract import K_BUCKETS, bucket_k
from .hybrid import (HybridIndex, dense_topk, embed_queries,
                     rerank_candidates, rrf_fuse)

_REGISTRY: dict[str, type] = {}


def register_engine(name: str):
    """Class decorator: register an Engine implementation under ``name``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def engine_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_engine(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; registered engines: "
                       f"{', '.join(engine_names())}") from None


@runtime_checkable
class Engine(Protocol):
    """What the Retriever facade drives. ``search`` executes one batch at
    depth ``k`` under pruning policy ``params`` and returns the raw
    engine result (internal ids already mapped to original docid space).

    ``replicate`` returns a fresh instance with the same configuration
    sharing the open index tensors (no rebuild, no copy)."""
    name: str

    def search(self, terms, weights_b, weights_l, dense, *, k: int,
               params: TwoLevelParams) -> RetrievalResult:
        ...

    def replicate(self, params: TwoLevelParams) -> "Engine":
        ...


def _require_bii(index, engine: str, device):
    """``index`` (fp32 or compressed; a HybridIndex's sparse side) on
    ``device`` (moved there if it lives elsewhere; asking for CUDA without
    a GPU raises)."""
    if isinstance(index, HybridIndex):
        index = index.sparse   # sparse engines serve the sparse side
    if not isinstance(index, (BlockedImpactIndex, CompressedImpactIndex)):
        raise TypeError(f"engine {engine!r} needs a BlockedImpactIndex or "
                        f"CompressedImpactIndex, got {type(index).__name__}")
    return index.to(device)


def _require_hybrid(index, engine: str, device) -> HybridIndex:
    if not isinstance(index, HybridIndex):
        raise TypeError(
            f"engine {engine!r} needs a HybridIndex (sparse index + dense "
            f"doc embeddings; see repro_torch.retrieval.build_hybrid_index)"
            f", got {type(index).__name__}")
    return index.to(device)


@register_engine("batched")
class BatchedEngine:
    """Batched tile scan with the plain torch tile scorer.

    ``traversal="chunked"`` replaces the all-tiles scan with the
    descending-bound chunk loop (early exit): bit-identical to the
    ``impact``-schedule full scan while dispatching only the live chunk
    prefix; stats gain ``chunks_dispatched``. ``chunk_tiles`` overrides
    ``params.chunk_tiles``.
    """

    use_kernel = False
    traversals = ("full", "chunked")

    # Engines hold no pruning params: the policy for each call arrives via
    # search(params=...), possibly with a per-call threshold_factor.
    def __init__(self, index, params: TwoLevelParams,
                 traversal: str = "full", chunk_tiles: int | None = None,
                 device="cuda"):
        self.index = _require_bii(index, self.name, device)
        if traversal not in self.traversals:
            raise ValueError(
                f"engine {self.name!r} supports traversal in "
                f"{self.traversals}, got {traversal!r}")
        self.traversal = traversal
        self.chunk_tiles = chunk_tiles

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        return retrieve_batched(self.index, terms, weights_b, weights_l,
                                params, use_kernel=self.use_kernel, k=k,
                                traversal=self.traversal,
                                chunk_tiles=self.chunk_tiles)

    def replicate(self, params):
        return type(self)(self.index, params, traversal=self.traversal,
                          chunk_tiles=self.chunk_tiles,
                          device=self.index.device)


@register_engine("kernel")
class KernelEngine(BatchedEngine):
    """Batched scan scored by the guided_score kernels.
    ``traversal="full"``/``"chunked"`` score tile by tile through
    ``guided_score_tile``; ``"chunked_fused"`` scores each chunk with one
    ``guided_score_chunk`` launch (chunk-start thresholds: rank-safe
    exact, guided within the usual tolerance). On a compressed index the
    decode-in-kernel twins ``guided_score_tile_q`` / ``guided_score_chunk_q``
    take their place. On a CPU index the kernels' plain versions run
    instead."""

    use_kernel = True
    traversals = ("full", "chunked", "chunked_fused")


@register_engine("sequential")
class SequentialEngine:
    """Host-driven per-query loop with physical tile skips; the paper's
    single-threaded latency regime. Responses carry per-query timings."""

    def __init__(self, index, params: TwoLevelParams, warmup: bool = True,
                 device="cuda"):
        self.index = _require_bii(index, self.name, device)
        self.warmup = warmup

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        return retrieve_sequential(self.index, terms, weights_b, weights_l,
                                   params, warmup=self.warmup, k=k)

    def replicate(self, params):
        return type(self)(self.index, params, warmup=self.warmup,
                          device=self.index.device)


@register_engine("sharded")
class ShardedEngine:
    """Tile ranges scanned per shard with a stable top-k merge
    (``serve.sharded.shard_retrieve_batched``).

    Accepts a ``BlockedImpactIndex`` or ``CompressedImpactIndex`` (or a
    HybridIndex's sparse side; partitioned here into ``n_shards`` shards on
    ``device``) or a prebuilt
    ``core.shard_plan.ShardedImpactIndex`` (moved to ``device`` if it lives
    elsewhere). ``mesh=None`` serves through the single-device emulation
    path; a ``serve.sharded.make_shard_mesh`` mesh runs shard ``rank`` on
    each rank of its group. ``use_kernel=True`` scores every shard tile
    through ``guided_score_tile`` (``guided_score_tile_q`` on q8).
    """

    traversals = ("full", "chunked")

    def __init__(self, index, params: TwoLevelParams, *,
                 n_shards: int | None = None, mesh=None,
                 axis_name: str = "shard", use_kernel: bool = False,
                 exchange_every: int = 0, traversal: str = "full",
                 chunk_tiles: int | None = None, device="cuda"):
        # imported here: serve.sharded imports serve.engine, which imports
        # this package
        from ..core.shard_plan import ShardedImpactIndex, shard_index
        if traversal not in self.traversals:
            raise ValueError(f"engine {self.name!r} supports traversal in "
                             f"{self.traversals}, got {traversal!r}")
        if mesh is not None and n_shards is None:
            n_shards = mesh.shape[axis_name]
        if isinstance(index, HybridIndex):
            index = index.sparse
        if isinstance(index, ShardedImpactIndex):
            self.sharded = index.to(device)
        else:
            if not isinstance(index, (BlockedImpactIndex,
                                      CompressedImpactIndex)):
                raise TypeError(
                    f"engine {self.name!r} needs a BlockedImpactIndex, "
                    f"CompressedImpactIndex or ShardedImpactIndex, got "
                    f"{type(index).__name__}")
            # the repack reads the index to the host once, wherever it is
            self.sharded = shard_index(index, n_shards or 1, device=device)
        self.mesh = mesh
        self.axis_name = axis_name
        self.use_kernel = use_kernel
        self.exchange_every = exchange_every
        self.traversal = traversal
        self.chunk_tiles = chunk_tiles

    @property
    def index(self):
        """The served index: the stacked shards."""
        return self.sharded

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        from ..serve.sharded import shard_retrieve_batched
        return shard_retrieve_batched(
            self.sharded, terms, weights_b, weights_l, params,
            mesh=self.mesh, axis_name=self.axis_name,
            use_kernel=self.use_kernel,
            exchange_every=self.exchange_every, k=k,
            traversal=self.traversal, chunk_tiles=self.chunk_tiles)

    def replicate(self, params):
        # hand over the prebuilt ShardedImpactIndex: a replica never
        # re-partitions the tile ranges
        return type(self)(self.sharded, params, mesh=self.mesh,
                          axis_name=self.axis_name,
                          use_kernel=self.use_kernel,
                          exchange_every=self.exchange_every,
                          traversal=self.traversal,
                          chunk_tiles=self.chunk_tiles,
                          device=self.sharded.device)


@register_engine("dense")
class DenseEngine:
    """2GTI transferred to blocked dense retrieval (two-tower candidates).

    Queries arrive as ``SearchRequest.dense`` [B, D] embeddings and the
    whole batch runs through one guided block scan
    (``core.dense_guided.retrieve_dense_batched``: each row keeps its own
    block order and thresholds). ``threshold_factor`` overrides are
    ignored: the dense skip test has no factor knob."""

    def __init__(self, index, params: TwoLevelParams, device="cuda"):
        if isinstance(index, HybridIndex):
            index = index.dense   # dense-only lane of a hybrid index
        if not isinstance(index, DenseGuidedIndex):
            raise TypeError(f"engine 'dense' needs a DenseGuidedIndex "
                            f"(core.dense_guided.build_dense_index), got "
                            f"{type(index).__name__}")
        self.index = index.to(device)

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        if dense is None:
            raise ValueError("engine 'dense' reads SearchRequest.dense "
                             "([B, D] query embeddings); got None")
        scores, ids, stats = retrieve_dense_batched(self.index, dense,
                                                    params, k=k)
        return RetrievalResult(ids=ids, scores=scores, global_ids=ids,
                               local_ids=ids, stats=stats)

    def replicate(self, params):
        return type(self)(self.index, params, device=self.index.device)


_HYBRID_FIRST_STAGES = ("batched", "kernel", "sequential", "sharded")


class _HybridBase:
    """Shared open-time plumbing of the two hybrid engines: a HybridIndex
    on ``device``, a sparse first stage from the registry, and a candidate
    depth k'.

    ``depth`` (k') is bucketed at call time together with the requested
    k, so a per-call k sweep runs the first stage at one depth per
    bucket. Extra ``**opts`` go to the first-stage constructor
    (``traversal="chunked_fused"``, ``n_shards=...``, ...)."""

    def __init__(self, index, params: TwoLevelParams, *,
                 depth: int = 100, first_stage: str = "batched",
                 device="cuda", **opts):
        self.hybrid = _require_hybrid(index, self.name, device)
        if first_stage not in _HYBRID_FIRST_STAGES:
            raise ValueError(
                f"engine {self.name!r} first_stage must be in "
                f"{_HYBRID_FIRST_STAGES}, got {first_stage!r}")
        if depth < 1:
            raise ValueError(f"depth={depth} must be >= 1")
        self.depth = int(depth)
        self.first = get_engine(first_stage)(self.hybrid.sparse, params,
                                             device=device, **opts)

    def replicate(self, params):
        """A replica sharing the HybridIndex and the first stage's open
        tensors (a sharded first stage keeps its partition)."""
        rep = copy.copy(self)
        rep.first = self.first.replicate(params)
        return rep

    def _depth_for(self, k: int) -> int:
        """Candidate depth of one call: at least the configured k' and
        the requested k, bucketed (and corpus-capped)."""
        return min(bucket_k(max(self.depth, k), K_BUCKETS),
                   self.hybrid.n_docs)

    def _first_stage(self, terms, weights_b, weights_l, dense, k, params):
        """(first-stage result at depth k1, rotated query embeddings, k1)."""
        k1 = self._depth_for(k)
        res = self.first.search(terms, weights_b, weights_l, None,
                                k=k1, params=params)
        q_rot = embed_queries(self.hybrid, terms, weights_l, dense=dense)
        return res, q_rot, k1


@register_engine("cascade")
class CascadeEngine(_HybridBase):
    """Sparse guided traversal at depth k', exact-dense rerank to k.

    Stage one is any sparse registry engine on the shared planner (the
    pruning policy, including per-call ``threshold_factor`` overrides,
    applies there); stage two gathers the k' candidates' embedding rows
    and takes the exact dense top-k (``hybrid.rerank_candidates``). Query
    embeddings come from ``SearchRequest.dense`` when provided, else from
    the sparse query via the index's ``q_proj`` bridge, so the engine
    serves plain sparse requests end to end (scheduler routing included).
    Scores in the response are *dense* scores, not RankScores."""

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        res, q_rot, k1 = self._first_stage(terms, weights_b, weights_l,
                                           dense, k, params)
        scores, ids = rerank_candidates(self.hybrid, q_rot,
                                        np.asarray(res.ids), k=k)
        stats = dict(res.stats)
        stats["cascade_depth"] = float(k1)
        return RetrievalResult(ids=ids, scores=scores, global_ids=ids,
                               local_ids=ids, stats=stats,
                               latencies_ms=res.latencies_ms)


@register_engine("rrf")
class RRFEngine(_HybridBase):
    """Reciprocal-rank fusion of the sparse and dense rankings.

    Both legs rank to depth k' (sparse: first-stage traversal under the
    pruning policy; dense: batched exact top-k' over the embedding
    table), then fuse with ``score(d) = sum 1/(rrf_k + rank_d)`` and
    keep the top k. Response scores are RRF scores, comparable within
    a response, not across engines."""

    def __init__(self, index, params: TwoLevelParams, *,
                 depth: int = 100, rrf_k: float = 60.0,
                 first_stage: str = "batched", device="cuda", **opts):
        super().__init__(index, params, depth=depth,
                         first_stage=first_stage, device=device, **opts)
        if rrf_k <= 0:
            raise ValueError(f"rrf_k={rrf_k} must be > 0")
        self.rrf_k = float(rrf_k)

    def search(self, terms, weights_b, weights_l, dense, *, k, params):
        res, q_rot, k1 = self._first_stage(terms, weights_b, weights_l,
                                           dense, k, params)
        _, dense_ids = dense_topk(self.hybrid, q_rot, k=k1)
        ids, scores = rrf_fuse(np.asarray(res.ids), dense_ids, k=k,
                               rrf_k=self.rrf_k)
        stats = dict(res.stats)
        stats["fusion_depth"] = float(k1)
        stats["rrf_k"] = self.rrf_k
        return RetrievalResult(ids=ids, scores=scores, global_ids=ids,
                               local_ids=ids, stats=stats,
                               latencies_ms=res.latencies_ms)
