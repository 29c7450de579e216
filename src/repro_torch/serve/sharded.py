"""Sharded retrieval: per-shard tile scans + a stable top-k merge.

The index is partitioned into contiguous tile ranges (``core.shard_plan``).
Every shard runs the *same* executor step as the single-device engine
(``core.traversal._tile_step``, planner from ``core.plan``) over its own
tiles, carrying shard-local top-k queues; the final queues are stacked in
shard order and merged with one stable top-k per queue. Stacking in shard
order before the merge keeps the single-device stable-tie rule: with the
``docid`` schedule the concatenation enumerates candidates in exactly the
global tile order, so for rank-safe configurations (alpha = beta = gamma)
the merged Q_Rk is bit-identical to ``retrieve_batched``: ids, scores and
tie-breaks. Guided (rank-unsafe) configurations prune against thresholds
whose trajectory depends on traversal order, so a shard's looser local
theta can keep boundary docs the sequential traversal froze; heads agree,
tails may differ within the usual guided tolerance.

Threshold exchange (``exchange_every``): every E tiles the shards share
their Global queues and set a floor theta, the k-th best Global score
across the union, i.e. the *exact* global theta at that point, so later
tile skips prune against the global queue rather than the local one.
Thresholds only tighten, so the floor is always safe. The tile order is
folded into rounds of E tiles (the tail padded with the sentinel tile
``tiles_per_shard``, force-skipped); round 0 runs without a floor and
every later round takes the floor from the carries at round start.

Two execution paths run one function per round (``_shard_round``), so
they are bit-identical by construction:

  - ``mesh`` path: one rank per shard in a ``torch.distributed`` group
    (``make_shard_mesh``); each rank scans shard ``rank``, all-gathers the
    Global queues at each round start for the floor, and all-gathers the
    final queues, stats and dispatch counts
    (``dist.collectives.ring_gather_stack``). Every rank returns the full
    result. The round count is static, so every rank joins the same
    collectives even when its chunk loop exits early.
  - emulation path (``mesh=None``): a host loop over the shards on one
    device, each round of every shard in turn, with the same merge math.

The scoring kernels are the single-device engine's: ``use_kernel=True``
scores every shard tile through ``guided_score_tile`` (fp32) or
``guided_score_tile_q`` (q8), on the card when the index lives there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.plan import chunk_schedule, tile_schedule
from ..core.shard_plan import ShardedImpactIndex
from ..core.traversal import (STAT_KEYS, Carry, RetrievalResult,
                              _as_tensor, _chunk_scan, _chunk_while,
                              _tile_step, _topk_stable, make_context)
from ..core.twolevel import TwoLevelParams, resolve_k
from ..dist.collectives import ring_gather_stack
from .engine import RetrievalServer, ServerConfig


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """One shard per rank of a ``torch.distributed`` group: the group, this
    rank and the group's size (``shape[axis_name]``, as a mesh's)."""
    group: object
    rank: int
    size: int
    axis_name: str = "shard"

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}


def make_shard_mesh(n_shards: int, axis_name: str = "shard", group=None):
    """The mesh of a ``torch.distributed`` group (``None``: the default
    group) of ``n_shards`` ranks, one shard each. The caller initialises
    the group (``init_process_group`` with address, world size and rank;
    gloo for CPU tensors, NCCL for CUDA tensors)."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a {n_shards}-shard mesh needs torch.distributed initialised "
            f"with {n_shards} ranks (init_process_group), or pass mesh=None "
            f"for the single-device emulation path")
    size = dist.get_world_size(group)
    if size != n_shards:
        raise ValueError(f"need {n_shards} ranks for a {n_shards}-shard "
                         f"mesh, the group has {size}")
    return ShardMesh(group, dist.get_rank(group), size, axis_name)


def _merge_stacked(vals, ids, k: int):
    """Merge shard-stacked queues [n, B, k] -> [B, k], shard-order stable."""
    n, b, kk = vals.shape
    v = vals.permute(1, 0, 2).reshape(b, n * kk)
    i = ids.permute(1, 0, 2).reshape(b, n * kk)
    top, idx = _topk_stable(v, k)
    return top, torch.gather(i, 1, idx)


def _global_theta(gv, k: int):
    """k-th best Global score across the union of shard queues: [n,B,k]->[B]."""
    n, b, kk = gv.shape
    v = gv.permute(1, 0, 2).reshape(b, n * kk)
    return _topk_stable(v, k)[0][:, -1]


def _fold_schedule(tiles, tiles_per_shard: int, exchange_every: int):
    """Reshape a tile order [B, T] into exchange rounds [B, R, E].

    E is the exchange period (the whole schedule when exchange is off).
    The tail round is padded with the sentinel tile ``tiles_per_shard``:
    it is >= every shard's real tile count, so ``_tile_step`` force-skips
    it and it touches no queue, stat or gather."""
    b, t = tiles.shape
    period = exchange_every if 0 < exchange_every < t else t
    n_rounds = -(-t // period)
    pad = n_rounds * period - t
    if pad:
        tiles = torch.cat([tiles, torch.full(
            (b, pad), tiles_per_shard, dtype=torch.int32,
            device=tiles.device)], -1)
    return tiles.reshape(b, n_rounds, period)


def _fold_chunk_rounds(chunks, chunk_ub, tiles_per_shard: int,
                       exchange_every: int, chunk_tiles: int):
    """Fold a chunk order [B, n_chunks, C] into exchange rounds
    [B, R, per_round, C] (+ bounds [B, R, per_round]).

    The exchange period is counted in tiles (as for the full scan) and
    rounded up to whole chunks; the tail round is padded with
    all-sentinel chunks (bound -inf)."""
    b, n_chunks, c = chunks.shape
    if 0 < exchange_every:
        per_round = min(max(1, -(-exchange_every // chunk_tiles)), n_chunks)
    else:
        per_round = n_chunks
    n_rounds = -(-n_chunks // per_round)
    pad = n_rounds * per_round - n_chunks
    if pad:
        chunks = torch.cat([chunks, torch.full(
            (b, pad, c), tiles_per_shard, dtype=torch.int32,
            device=chunks.device)], 1)
        chunk_ub = torch.cat([chunk_ub, torch.full(
            (b, pad), -torch.inf, device=chunk_ub.device)], 1)
    return (chunks.reshape(b, n_rounds, per_round, c),
            chunk_ub.reshape(b, n_rounds, per_round))


def _rebase(ids, base: int):
    return torch.where(ids >= 0, ids + base, ids)


class _Shard:
    """One shard's fixed state for a call: its index view, the call's
    context on it, its real tile count, its docid base and its exchange
    rounds (tile rounds [B, R, E], or chunk rounds and their bounds)."""

    def __init__(self, sharded: ShardedImpactIndex, s: int, ctx, traversal,
                 schedule: str, exchange_every: int, chunk_tiles: int):
        view = sharded.shard(s)
        self.ctx = dataclasses.replace(ctx, index=view)
        self.n_real = sharded.n_real(s)
        self.base = sharded.base(s)
        tps = sharded.tiles_per_shard
        self.chunked = traversal == "chunked"
        if self.chunked:
            sched = chunk_schedule(ctx.plan, view.tile_max_b,
                                   view.tile_max_l, ctx.alpha, tps,
                                   chunk_tiles, self.n_real)
            self.rounds, self.ub = _fold_chunk_rounds(
                sched.chunks, sched.chunk_ub, tps, exchange_every,
                chunk_tiles)
        else:
            tiles = tile_schedule(ctx.plan, view.tile_max_b,
                                  view.tile_max_l, ctx.alpha, tps, schedule)
            self.rounds = _fold_schedule(tiles, tps, exchange_every)
            self.ub = None

    @property
    def n_rounds(self) -> int:
        return self.rounds.shape[1]


def _shard_round(sh: _Shard, carry: Carry, disp, r: int, th_floor):
    """Advance every query of one shard over its exchange round ``r`` with
    the floor ``th_floor`` ([B], or None in round 0). Full: one
    ``_tile_step`` per tile of the round. Chunked: the shared
    ``_chunk_while`` early-exit loop over the round's chunks, whose
    per-query count of chunks dispatched adds to ``disp``. Returns the
    carry and ``disp``."""
    rnd = sh.rounds[:, r]
    if sh.chunked:
        def advance(i, c):
            return _chunk_scan(sh.ctx, c, rnd[:, i], sh.n_real, th_floor)
        carry, d = _chunk_while(advance, sh.ub[:, r], carry, sh.ctx.factor,
                                th_floor)
        return carry, disp + d
    for t in range(rnd.shape[1]):
        carry = _tile_step(sh.ctx, carry, rnd[:, t], sh.n_real, th_floor)
    return carry, disp


def _final_stack(sh: _Shard, carry: Carry, disp):
    """One shard's output rows: rebased queues, stats, dispatch counts."""
    return (carry.gv, _rebase(carry.gi, sh.base), carry.lv,
            _rebase(carry.li, sh.base), carry.rv, _rebase(carry.ri, sh.base),
            carry.st, disp)


def _emulated(shards, b: int, k: int, dev):
    """Every shard on this device, round by round."""
    carries = [Carry.init(b, k, dev) for _ in shards]
    disps = [torch.zeros(b, dtype=torch.float32, device=dev)
             for _ in shards]
    for r in range(shards[0].n_rounds):
        floor = (None if r == 0 else
                 _global_theta(torch.stack([c.gv for c in carries]), k))
        for s, sh in enumerate(shards):
            carries[s], disps[s] = _shard_round(sh, carries[s], disps[s],
                                                r, floor)
    outs = [_final_stack(sh, c, d) for sh, c, d in zip(shards, carries,
                                                       disps)]
    return [torch.stack(parts) for parts in zip(*outs)]


def _distributed(sh: _Shard, mesh: ShardMesh, b: int, k: int, dev):
    """This rank's shard; the floors and the outputs all-gathered."""
    carry = Carry.init(b, k, dev)
    disp = torch.zeros(b, dtype=torch.float32, device=dev)
    for r in range(sh.n_rounds):
        floor = (None if r == 0 else
                 _global_theta(ring_gather_stack(carry.gv, mesh.group), k))
        carry, disp = _shard_round(sh, carry, disp, r, floor)
    return [ring_gather_stack(t, mesh.group)
            for t in _final_stack(sh, carry, disp)]


def shard_retrieve_batched(sharded: ShardedImpactIndex, q_terms, qw_b, qw_l,
                           params: TwoLevelParams, mesh=None,
                           axis_name: str = "shard",
                           use_kernel: bool = False,
                           exchange_every: int = 0,
                           k: int | None = None,
                           traversal: str = "full",
                           chunk_tiles: int | None = None
                           ) -> RetrievalResult:
    """Sharded batched retrieval over a stacked shard index.

    ``mesh=None`` runs the emulation path (any shard count on one device,
    bit-identical to the mesh path); a ``make_shard_mesh`` mesh whose
    ``axis_name`` size equals ``sharded.n_shards`` runs the collective
    path, rank r scanning shard r. ``exchange_every=E`` shares the exact
    global theta_Gl every E tiles so shards skip against the global queue.
    ``k`` is the per-call retrieval depth (legacy ``params.k`` fallback).

    ``traversal="chunked"``: each shard scans its tiles in descending
    local-bound chunks of ``chunk_tiles`` (default ``params.chunk_tiles``)
    under the early-exit loop that stops at the first bound-failing chunk:
    bit-identical to the ``impact``-schedule full scan per shard
    (shape-padding tiles sort last with -inf bounds and never keep the
    loop alive). With ``exchange_every=E`` the exchange period is rounded
    up to whole chunks and the early exit applies within each round.
    Stats gain ``chunks_dispatched`` / ``n_chunks`` (summed over shards)
    and ``shard_chunks_dispatched``.
    """
    if mesh is not None and mesh.shape[axis_name] != sharded.n_shards:
        raise ValueError(
            f"mesh axis {axis_name!r} has size {mesh.shape[axis_name]} but "
            f"the index has {sharded.n_shards} shards")
    if traversal not in ("full", "chunked"):
        raise ValueError(f"sharded traversal must be 'full' or 'chunked', "
                         f"got {traversal!r}")
    dev = sharded.device
    q_terms = _as_tensor(q_terms, torch.int32, dev)
    qw_b = _as_tensor(qw_b, torch.float32, dev)
    qw_l = _as_tensor(qw_l, torch.float32, dev)
    k = resolve_k(params, k)
    ct = int(chunk_tiles if chunk_tiles is not None else params.chunk_tiles)
    b = q_terms.shape[0]
    # one plan for every shard: it reads only the global list maxima
    ctx = make_context(sharded.shard(0), q_terms, qw_b, qw_l, params, k,
                       use_kernel)

    def shard(s):
        return _Shard(sharded, s, ctx, traversal, params.schedule,
                      exchange_every, ct)
    if mesh is None:
        out = _emulated([shard(s) for s in range(sharded.n_shards)], b, k,
                        dev)
    else:
        out = _distributed(shard(mesh.rank), mesh, b, k, dev)
    gv, gi, lv, li, rv, ri, st, disp = out
    (gv, gi), (lv, li), (rv, ri) = (_merge_stacked(v, i, k) for v, i in
                                    ((gv, gi), (lv, li), (rv, ri)))
    st = st.cpu().numpy()                              # [n_shards, B, 5]
    stats = dict(zip(STAT_KEYS, st.sum(0).T))
    # padding tiles are force-skipped, so the real tile count is the
    # denominator: skip rates stay comparable with retrieve_batched
    stats["n_tiles"] = np.full(b, sharded.n_tiles, np.float32)
    stats["shard_tiles_visited"] = st[:, :, 4].T       # [B, n_shards]
    if traversal == "chunked":
        disp = disp.cpu().numpy()
        stats["chunks_dispatched"] = disp.sum(0)       # [B]
        n_chunks = -(-sharded.tiles_per_shard // ct) * sharded.n_shards
        stats["n_chunks"] = np.full(b, n_chunks, np.float32)
        stats["shard_chunks_dispatched"] = disp.T      # [B, n_shards]
    return RetrievalResult(ids=sharded.to_orig(ri.cpu().numpy()),
                           scores=rv.cpu().numpy(),
                           global_ids=sharded.to_orig(gi.cpu().numpy()),
                           local_ids=sharded.to_orig(li.cpu().numpy()),
                           stats=stats)


class ShardedRetrievalServer(RetrievalServer):
    """Deprecated (with :class:`RetrievalServer`): the same shim over
    ``AsyncRetrievalScheduler``, pinned to the sharded engine. New code
    opens a scheduler with a routing policy whose routes use
    ``engine="sharded"`` (``route(..., engine="sharded", n_shards=N)``).

    Accepts the same queue/batching config; the index is partitioned once
    at construction (inside the ``"sharded"`` registry engine).
    ``mesh=None`` serves through the emulation path."""

    def __init__(self, index, params: TwoLevelParams,
                 cfg: ServerConfig | None = None, *,
                 n_shards: int | None = None, mesh=None,
                 axis_name: str = "shard", use_kernel: bool = False,
                 exchange_every: int = 0, k: int | None = None,
                 traversal: str = "full", chunk_tiles: int | None = None,
                 device="cuda"):
        super().__init__(index, params, cfg, engine="sharded", k=k,
                         device=device, n_shards=n_shards, mesh=mesh,
                         axis_name=axis_name, use_kernel=use_kernel,
                         exchange_every=exchange_every,
                         traversal=traversal, chunk_tiles=chunk_tiles)
        self.sharded = self.retriever.engine.sharded
        self.mesh = mesh
