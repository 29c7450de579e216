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

Third-party backends register with ``@register_engine("name")``; the class
must accept ``(index, params, device=..., **opts)`` and implement
``search``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from ..core.index import BlockedImpactIndex
from ..core.traversal import (RetrievalResult, retrieve_batched,
                              retrieve_sequential)
from ..core.twolevel import TwoLevelParams
from ..index.compressed import CompressedImpactIndex

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
    """``index`` (fp32 or compressed) on ``device`` (moved there if it
    lives elsewhere; asking for CUDA without a GPU raises)."""
    if not isinstance(index, (BlockedImpactIndex, CompressedImpactIndex)):
        raise TypeError(f"engine {engine!r} needs a BlockedImpactIndex or "
                        f"CompressedImpactIndex, got {type(index).__name__}")
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

    Accepts a ``BlockedImpactIndex`` or ``CompressedImpactIndex``
    (partitioned here into ``n_shards`` shards on ``device``) or a prebuilt
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
