"""Two-level guided tile-scan traversal: the paper's algorithm in PyTorch.

The docid space is scanned tile by tile, carrying three top-k queues whose
thresholds tighten monotonically (the DAAT threshold dynamic at tile
granularity). Per tile:

  1. *Tile skip* (global level): sum of alpha-combined per-(term, tile)
     maxima <= theta_Gl  =>  no doc in the tile can qualify; skip.
  2. *Term partitioning* (global level): terms presorted ascending by
     alpha-combined list maxima; the prefix whose bound sum stays <= theta_Gl
     is non-essential. Docs with no essential-term posting are pruned and
     enter no queue.
  3. *Local level*: surviving docs accumulate weights term by term in
     descending order. Before each non-essential term, docs whose
     beta-partial + beta-combined remaining bound <= theta_Lo freeze: they
     stop accumulating but keep their partial gamma-combined RankScore,
     which still enters Q_Rk (paper queue discipline).
  4. Tile-local top-k of Global/Local/Rank merge into the carried queues.

Every executor runs a batch of queries at once: the carry, the plans and
the schedules hold a leading ``[B]`` dimension, and the tile loops run on
the host:

  - ``retrieve_batched(traversal="full")``: every row visits all its tiles
    in ``params.schedule`` order; skipped tiles are masked compute.
  - ``traversal="chunked"``: descending-bound tile chunks under the
    ``_chunk_while`` early-exit rule; each tile of a chunk is one
    ``_tile_step`` (bit-identical to the full impact-ordered scan).
  - ``traversal="chunked_fused"``: the same chunk loop, each chunk scored
    by one ``guided_score_chunk`` launch with chunk-start thresholds.
  - ``retrieve_sequential``: per-query host loop with physical skipping.

``score_tile`` scores through the ``guided_score_tile`` kernel or its
plain PyTorch version, as ``use_kernel`` chooses. Either index type is
served: the fp32 ``BlockedImpactIndex`` and the compressed
``repro_torch.index.CompressedImpactIndex`` share the planner metadata and
differ only in their gather (``core.index.dispatch_gather``). On the
compressed index with ``use_kernel=True`` the executors pass undecoded
rows to the decode-in-kernel ``guided_score_tile_q`` /
``guided_score_chunk_q``, whose 6th row (postings per slot) gives the
presence and postings stats. Top-k selection uses a stable descending
sort, which keeps the reference's tie rule: equal values keep their
order, lower index first.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.guided_score import (guided_score_chunk, guided_score_chunk_q,
                                    guided_score_tile, guided_score_tile_plain,
                                    guided_score_tile_q)
from .index import BlockedImpactIndex, dispatch_gather
from .plan import (QueryPlan, chunk_schedule, essential_terms,
                   freeze_bounds, plan_query, term_bounds, tile_schedule,
                   tile_upper_bounds)
from .twolevel import TwoLevelParams, resolve_k

STAT_KEYS = ("docs_present", "docs_survived", "docs_frozen",
             "postings_touched", "tiles_visited")

# The per-query counters worth attaching to a request's execute span: the
# executor stats plus the chunked traversal's dispatch counts (absent from
# engines that do not produce them). Read by ``repro_torch.obs.trace_exec``;
# keep in step with retrieve_batched's stats.
TRACE_STAT_KEYS = STAT_KEYS + ("n_tiles", "chunks_dispatched", "n_chunks")

TRAVERSALS = ("full", "chunked", "chunked_fused")


@dataclasses.dataclass
class RetrievalResult:
    ids: np.ndarray        # [B, k] int32 (Q_Rk docids, score-desc)
    scores: np.ndarray     # [B, k] float32 (RankScore)
    global_ids: np.ndarray
    local_ids: np.ndarray
    stats: dict            # per-query counters
    latencies_ms: np.ndarray | None = None  # sequential mode only


@dataclasses.dataclass
class Carry:
    """The three top-k queues and the stat sums of a batch of queries."""
    gv: torch.Tensor   # [B, k] f32 Q_Gl values, descending
    gi: torch.Tensor   # [B, k] int32 Q_Gl docids
    lv: torch.Tensor
    li: torch.Tensor
    rv: torch.Tensor
    ri: torch.Tensor
    st: torch.Tensor   # [B, 5] f32 stat sums in STAT_KEYS order

    @classmethod
    def init(cls, b: int, k: int, device) -> "Carry":
        def vals():
            return torch.full((b, k), -torch.inf, dtype=torch.float32,
                              device=device)

        def ids():
            return torch.full((b, k), -1, dtype=torch.int32, device=device)
        return cls(vals(), ids(), vals(), ids(), vals(), ids(),
                   torch.zeros((b, 5), dtype=torch.float32, device=device))


def _topk_stable(vals, k: int):
    """Top-k along the last dim with ``lax.top_k``'s tie rule (lower index
    first): a stable descending sort, cut to ``k``."""
    top, idx = torch.sort(vals, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _merge_queue(q_vals, q_ids, c_vals, c_ids, k: int):
    """Merge candidates [B, n] into sorted top-k queues [B, k] (stable ties:
    queue entries precede candidates, candidates keep their order)."""
    vals = torch.cat([q_vals, c_vals], -1)
    ids = torch.cat([q_ids, c_ids], -1)
    top, idx = _topk_stable(vals, k)
    return top, torch.gather(ids, -1, idx)


def _tile_topk(scores, mask, kq: int):
    vals, idx = _topk_stable(torch.where(mask, scores, -torch.inf), kq)
    return vals, idx.to(torch.int32)


def _slot_presence(offs, tile_size: int):
    """Per (row, tile): the number of slots holding at least one posting,
    counted over all query terms ([..., Nq, P] -> [...] f32)."""
    valid = offs >= 0
    slot = torch.where(valid, offs, tile_size).long().flatten(-2)
    cnt = torch.zeros(slot.shape[:-1] + (tile_size + 1,),
                      dtype=torch.float32, device=offs.device)
    cnt.scatter_add_(-1, slot, valid.flatten(-2).float())
    return (cnt[..., :tile_size] > 0).sum(-1).float()


def _offs_counts(offs, tile_size: int):
    """(present slots, valid postings) per (row, tile) from gathered
    offsets."""
    return (_slot_presence(offs, tile_size),
            (offs >= 0).sum((-2, -1)).float())


def _row5_counts(out):
    """(present slots, valid postings) per (row, tile) from a q8 scorer's
    6th row, the postings per slot."""
    slot_cnt = out[..., 5, :]
    return (slot_cnt > 0).sum(-1).float(), slot_cnt.sum(-1)


def _candidates(out, counts, kq: int):
    """From a scorer's rows ``out`` [..., 5 (or 6), S]: the top-``kq``
    candidates of Global and Local (eval mask) and Rank (rank mask), and
    the stat counters [..., 4]. ``counts`` are the (present, postings)
    pair of ``_offs_counts`` or ``_row5_counts``."""
    g, l, r, eval_m, rank_m = out[..., :5, :].unbind(-2)
    eval_mask = eval_m > 0
    rank_mask = rank_m > 0
    present, postings = counts
    stats = torch.stack([present, rank_m.sum(-1),
                         (rank_mask & ~eval_mask).sum(-1).float(),
                         postings], -1)
    return (_tile_topk(g, eval_mask, kq), _tile_topk(l, eval_mask, kq),
            _tile_topk(r, rank_mask, kq), stats)


def score_tile(offs, wb, wl, essential, prefix_beta, th_lo,
               alpha, beta, gamma, *, tile_size: int, kq: int,
               use_kernel: bool = False):
    """Score one tile per query. See the module docstring for the levels.

    offs:        [B, Nq, P] int32 local doc offsets (-1 = padding)
    wb, wl:      [B, Nq, P] f32 query-weighted posting weights (0 = padding)
    essential:   [B, Nq] bool essential-term mask (planner, sorted order)
    prefix_beta: [B, Nq] f32 inclusive beta-bound prefix sums (planner)
    th_lo:       [B] f32
    ``use_kernel`` scores through the ``guided_score_tile`` kernel (its
    plain version on CPU tensors), else through the plain version.
    Returns three (vals, local_idx) candidate sets + [B, 4] stat counters.
    """
    score = guided_score_tile if use_kernel else guided_score_tile_plain
    out = score(offs, wb, wl, essential.float(), prefix_beta, th_lo,
                alpha, beta, gamma, tile_size=tile_size)
    return _candidates(out, _offs_counts(offs, tile_size), kq)


@dataclasses.dataclass
class Context:
    """What every step of one retrieve call reads: the index, the plans,
    the f32 coefficients and the sizes (``make_context`` builds it).
    ``raw_q8``: the scorers decode in-kernel (compressed index and
    ``use_kernel``), so the steps gather undecoded rows."""
    index: BlockedImpactIndex
    plan: QueryPlan
    alpha: float       # float32 values held as Python floats (see _f32)
    beta: float
    gamma: float
    factor: float
    k: int
    kq: int
    bound_mode: str
    use_kernel: bool = False

    @property
    def raw_q8(self) -> bool:
        return self.use_kernel and self.index.gather_kind == "q8"


def _floored(gv, th_floor):
    """Each row's theta_Gl (the k-th Global value), raised to ``th_floor``
    ([B]) when one is given."""
    th_gl = gv[:, -1]
    return th_gl if th_floor is None else torch.maximum(th_gl, th_floor)


def _thresholds(ctx: Context, carry: Carry, th_floor=None):
    """(theta_Gl, theta_Lo) of each row, threshold_factor applied.

    ``th_floor`` ([B] f32, optional) is an externally supplied lower bound
    on theta_Gl: the sharded path injects the exchanged global threshold
    here so a shard prunes against the global queue, not just its local
    one. Thresholds only tighten, so any floor <= the true global theta is
    safe. theta_Lo is never floored."""
    return (_floored(carry.gv, th_floor) * ctx.factor,
            carry.lv[:, -1] * ctx.factor)


def _merge_candidates(ctx: Context, carry: Carry, cands, tiles, skip):
    """Merge per-tile candidates into the carry's queues.

    ``cands`` are three (vals, local_idx) pairs shaped [B, T, kq] for the
    T tiles ``tiles`` [B, T]; ``skip`` [B, T] masks a tile's candidates to
    -inf. Merging the T tiles at once equals merging them one after the
    other: both keep the top-k of one order, value descending and then
    queue-before-candidate, earlier tile first."""
    base = tiles.to(torch.int32)[..., None] * ctx.index.tile_size
    queues = []
    for (q_vals, q_ids), (vals, idx) in zip(
            ((carry.gv, carry.gi), (carry.lv, carry.li), (carry.rv, carry.ri)),
            cands):
        vals = torch.where(skip[..., None], -torch.inf, vals)
        queues.append(_merge_queue(q_vals, q_ids, vals.flatten(1),
                                   (base + idx).flatten(1), ctx.k))
    (carry.gv, carry.gi), (carry.lv, carry.li), (carry.rv, carry.ri) = queues


def _add_stats(carry: Carry, stats, skip):
    """Add tile stats [B, T, 4] and the visit count, tile after tile."""
    for t in range(stats.shape[1]):
        visited = torch.where(skip[:, t], 0.0, 1.0)[:, None]
        carry.st = carry.st + torch.cat(
            [torch.where(skip[:, t, None], 0.0, stats[:, t]), visited], -1)


class StepInputs(NamedTuple):
    """What a scorer reads for one tile ([B]) or one chunk ([B, C]) per row:
    the planner's decisions and the gathered runs."""
    skip: torch.Tensor         # [B(, C)] bool
    essential: torch.Tensor    # [B(, C), Nq] bool
    prefix_beta: torch.Tensor  # [B(, C), Nq] f32
    th_lo: torch.Tensor        # [B] f32
    # (offs, wb, wl) query-weighted, [B(, C), Nq, P]; or, when
    # ``ctx.raw_q8``, the raw q8 rows (words, qb_row, ql_row, meta_i,
    # meta_f) of ``index.compressed.gather_tile_q_raw``
    rows: tuple


def step_inputs(ctx: Context, carry: Carry, tiles,
                n_valid: int | None = None, th_floor=None) -> StepInputs:
    """Plan bounds, skip test and gather for ``tiles`` ([B] or [B, C]) from
    the carry's current thresholds (theta_Gl raised to ``th_floor``, see
    ``_thresholds``). Tiles with id >= ``n_valid`` (the chunk sentinel, a
    shard's padding tiles) are force-skipped."""
    index, plan = ctx.index, ctx.plan
    th_gl, th_lo = _thresholds(ctx, carry, th_floor)
    lead = (slice(None),) + (None,) * (tiles.dim() - 1)
    th_gl = th_gl[lead]
    m_alpha, m_beta, ub_gl = term_bounds(plan, index.tile_max_b,
                                         index.tile_max_l, tiles, ctx.alpha,
                                         ctx.beta, ctx.bound_mode)
    skip = ub_gl <= th_gl
    if n_valid is not None:
        skip = skip | (tiles >= n_valid)
    if ctx.raw_q8:
        # imported here: repro_torch.index imports this package
        from ..index.compressed import gather_tile_q_raw
        rows = gather_tile_q_raw(index.gather_arrays(), plan.qt[lead], tiles,
                                 pad_len=index.pad_len)
    else:
        rows = dispatch_gather(index.gather_kind, index.gather_arrays(),
                               plan.qt[lead], tiles, plan.qwb[lead],
                               plan.qwl[lead], pad_len=index.pad_len,
                               tile_size=index.tile_size)
    return StepInputs(skip, essential_terms(m_alpha, th_gl),
                      freeze_bounds(m_beta), th_lo, rows)


def _tile_step(ctx: Context, carry: Carry, tile,
               n_valid: int | None = None, th_floor=None) -> Carry:
    """One tile visit per row (``tile`` [B]): plan bounds -> skip test ->
    score -> queue merge."""
    x = step_inputs(ctx, carry, tile, n_valid, th_floor)
    coef = (ctx.alpha, ctx.beta, ctx.gamma)
    tile_size = ctx.index.tile_size
    if ctx.raw_q8:
        out = guided_score_tile_q(*x.rows, ctx.plan.qwb, ctx.plan.qwl,
                                  x.essential.float(), x.prefix_beta,
                                  x.th_lo, *coef, tile_size=tile_size)
        *cands, stats = _candidates(out, _row5_counts(out), ctx.kq)
    else:
        *cands, stats = score_tile(*x.rows, x.essential, x.prefix_beta,
                                   x.th_lo, *coef, tile_size=tile_size,
                                   kq=ctx.kq, use_kernel=ctx.use_kernel)
    cands = [(v[:, None], i[:, None]) for v, i in cands]
    _merge_candidates(ctx, carry, cands, tile[:, None], x.skip[:, None])
    _add_stats(carry, stats[:, None], x.skip[:, None])
    return carry


def _chunk_scan(ctx: Context, carry: Carry, tiles_chunk,
                n_valid: int, th_floor=None) -> Carry:
    """Advance every row over one chunk of its tile order ([B, C]).

    Exact per-tile semantics: every tile re-reads the carry's thresholds,
    so the operation sequence is identical to the full scan's. Sentinel
    tiles (id >= n_valid) are force-skipped."""
    for c in range(tiles_chunk.shape[1]):
        carry = _tile_step(ctx, carry, tiles_chunk[:, c], n_valid, th_floor)
    return carry


def _chunk_step_fused(ctx: Context, carry: Carry, tiles_chunk,
                      n_valid: int, th_floor=None) -> Carry:
    """Advance every row over one chunk ([B, C]) with one
    ``guided_score_chunk`` (q8: ``guided_score_chunk_q``) launch.

    The skip predicate, essential partition and freeze bounds of every tile
    in the chunk derive from the *chunk-start* thresholds (the carry is
    not updated mid-kernel). Within a chunk that only loosens the pruning,
    so rank-safe configs stay bound-exact; guided configs follow a slightly
    different, still bound-safe, threshold trajectory."""
    tile_size = ctx.index.tile_size
    x = step_inputs(ctx, carry, tiles_chunk, n_valid, th_floor)
    args = (x.essential.float(), x.prefix_beta, x.skip.to(torch.int32),
            x.th_lo, ctx.alpha, ctx.beta, ctx.gamma)
    if ctx.raw_q8:
        out = guided_score_chunk_q(*x.rows, ctx.plan.qwb, ctx.plan.qwl,
                                   *args, tile_size=tile_size)
        counts = _row5_counts(out)
    else:
        out = guided_score_chunk(*x.rows, *args, tile_size=tile_size)
        counts = _offs_counts(x.rows[0], tile_size)
    *cands, stats = _candidates(out, counts, ctx.kq)
    _merge_candidates(ctx, carry, cands, tiles_chunk, x.skip)
    _add_stats(carry, stats, x.skip)
    return carry


def _chunk_while(advance, chunk_ub, carry: Carry, factor, th_floor=None):
    """Early-exit loop over a chunk sequence: the Block-Max-Pruning
    termination rule, shared by the batched executor and the sharded
    per-shard rounds (``serve.sharded``).

    Dispatches chunk ``i`` (``advance(i, carry)``) while any row's chunk
    bound ``chunk_ub[:, i]`` beats its (floored, see ``_thresholds``)
    theta_Gl * factor; per-chunk bounds descend and thresholds only
    tighten, so the first failing chunk proves every later tile fails its
    per-tile skip test too. Returns the carry and the per-row count of
    chunks that were live when dispatched.

    The test reads one bool back to the host per chunk: a device sync per
    chunk."""
    disp = torch.zeros(chunk_ub.shape[0], dtype=torch.float32,
                       device=chunk_ub.device)
    for i in range(chunk_ub.shape[1]):
        active = chunk_ub[:, i] > _floored(carry.gv, th_floor) * factor
        if not bool(active.any()):
            break
        carry = advance(i, carry)
        disp = disp + active.float()
    return carry, disp


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float. Torch computes a float32
    tensor op with a Python scalar in float32, and ``1.0 - x`` of such a
    value is exact in double, so the arithmetic rounds as it does with the
    reference's float32 scalars, and no coefficient lives on the device."""
    return float(np.float32(x))


def make_context(index, q_terms, qw_b, qw_l, params: TwoLevelParams,
                 k: int, use_kernel: bool) -> Context:
    """Plan the batch and fix the coefficients of one retrieve call."""
    alpha = _f32(params.alpha)
    plan = plan_query(q_terms, qw_b, qw_l, index.sigma_b, index.sigma_l,
                      alpha)
    return Context(index=index, plan=plan, alpha=alpha,
                beta=_f32(params.beta), gamma=_f32(params.gamma),
                factor=_f32(params.threshold_factor), k=k,
                kq=min(k, index.tile_size), bound_mode=params.bound_mode,
                use_kernel=use_kernel)


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def retrieve_batched(index: BlockedImpactIndex, q_terms, qw_b, qw_l,
                     params: TwoLevelParams,
                     use_kernel: bool = False,
                     k: int | None = None,
                     traversal: str = "full",
                     chunk_tiles: int | None = None) -> RetrievalResult:
    """Batched retrieval: q_terms [B, Nq] int32 (pad with qw = 0).

    ``index`` may be a ``BlockedImpactIndex`` or a
    ``repro_torch.index.CompressedImpactIndex`` (decoded in the gather, or
    in the ``_q`` kernels when ``use_kernel=True``).

    ``k`` is the retrieval depth for this call (falls back to the
    deprecated ``params.k`` stash, then DEFAULT_K). ``use_kernel=True``
    scores tiles through the ``guided_score_tile`` kernel (its plain
    version on CPU tensors).

    ``traversal``:
      - ``"full"``: every tile in ``params.schedule`` order; skipped tiles
        are masked compute.
      - ``"chunked"``: descending-bound tile chunks under an early-exit
        loop: bit-identical (ids, scores, stats) to the full scan with the
        ``impact`` schedule. Stats gain ``chunks_dispatched`` / ``n_chunks``.
      - ``"chunked_fused"``: the same chunk loop, each chunk scored by one
        ``guided_score_chunk`` launch with chunk-start thresholds.
    ``chunk_tiles`` overrides ``params.chunk_tiles`` for this call.
    """
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be in {TRAVERSALS}, "
                         f"got {traversal!r}")
    dev = index.device
    q_terms = _as_tensor(q_terms, torch.int32, dev)
    qw_b = _as_tensor(qw_b, torch.float32, dev)
    qw_l = _as_tensor(qw_l, torch.float32, dev)
    k = resolve_k(params, k)
    ctx = make_context(index, q_terms, qw_b, qw_l, params, k, use_kernel)
    b = q_terms.shape[0]
    carry = Carry.init(b, k, dev)
    disp = None
    if traversal == "full":
        tiles = tile_schedule(ctx.plan, index.tile_max_b, index.tile_max_l,
                              ctx.alpha, index.n_tiles, params.schedule)
        for t in range(index.n_tiles):
            carry = _tile_step(ctx, carry, tiles[:, t])
    else:
        ct = int(chunk_tiles if chunk_tiles is not None
                 else params.chunk_tiles)
        chunks, chunk_ub = chunk_schedule(ctx.plan, index.tile_max_b,
                                          index.tile_max_l, ctx.alpha,
                                          index.n_tiles, ct)
        step = (_chunk_step_fused if traversal == "chunked_fused"
                else _chunk_scan)

        def advance(i, carry):
            return step(ctx, carry, chunks[:, i], index.n_tiles)
        carry, disp = _chunk_while(advance, chunk_ub, carry, ctx.factor)

    st = carry.st.cpu().numpy()
    stats = dict(zip(STAT_KEYS, st.T))
    stats["n_tiles"] = np.full(b, index.n_tiles, np.float32)
    if disp is not None:
        stats["chunks_dispatched"] = disp.cpu().numpy()
        stats["n_chunks"] = np.full(b, -(-index.n_tiles // ct), np.float32)
    return RetrievalResult(ids=index.to_orig(carry.ri.cpu().numpy()),
                           scores=carry.rv.cpu().numpy(),
                           global_ids=index.to_orig(carry.gi.cpu().numpy()),
                           local_ids=index.to_orig(carry.li.cpu().numpy()),
                           stats=stats)


# ---------------------------------------------------------------------------
# Sequential mode: host tile loop with physical skipping (latency benchmarks).
# ---------------------------------------------------------------------------

def retrieve_sequential(index: BlockedImpactIndex, q_terms, qw_b, qw_l,
                        params: TwoLevelParams,
                        warmup: bool = True,
                        k: int | None = None) -> RetrievalResult:
    """Host-driven per-query traversal with physical tile skipping + timing.

    Mirrors the paper's single-threaded latency regime: a skipped tile
    costs nothing (no gather, no scoring). Planning runs through the same
    ``core.plan`` functions as the batched engine; only the skip *decision*
    is read back to the host so it can elide work. Each query's time ends
    with its results on the host.
    """
    B = len(q_terms)
    k = resolve_k(params, k)
    dev = index.device
    factor = params.threshold_factor
    ids = np.full((B, k), -1, np.int32)
    scores = np.full((B, k), -np.inf, np.float32)
    g_ids = np.full((B, k), -1, np.int32)
    l_ids = np.full((B, k), -1, np.int32)
    lat = np.zeros(B, np.float64)
    stat_rows = np.zeros((B, 6), np.float32)

    def run_query(qi, record):
        qt = _as_tensor(np.asarray(q_terms[qi])[None], torch.int32, dev)
        qwb = _as_tensor(np.asarray(qw_b[qi])[None], torch.float32, dev)
        qwl = _as_tensor(np.asarray(qw_l[qi])[None], torch.float32, dev)
        ctx = make_context(index, qt, qwb, qwl, params, k, use_kernel=False)
        ub = tile_upper_bounds(ctx.plan, index.tile_max_b, index.tile_max_l,
                               ctx.alpha)[0].cpu().numpy()
        impact = params.schedule == "impact"
        tile_order = (np.argsort(-ub, kind="stable") if impact
                      else np.arange(index.n_tiles))
        t0 = time.perf_counter()
        carry = Carry.init(1, k, dev)
        th_gl = -np.inf
        for tau in tile_order:
            if ub[tau] <= th_gl * factor:  # th_gl=-inf never skips
                if impact:
                    break  # ub descending: every later tile fails too
                continue
            carry = _tile_step(ctx, carry, torch.full((1,), int(tau),
                                                      dtype=torch.int32,
                                                      device=dev))
            th_gl = float(carry.gv[0, -1])
        out = [x[0].cpu().numpy() for x in (carry.gi, carry.li, carry.ri,
                                            carry.rv, carry.st)]
        dt = (time.perf_counter() - t0) * 1e3
        if record:
            gi, li, ri, rv, st = out
            ids[qi], scores[qi] = ri, rv
            g_ids[qi], l_ids[qi] = gi, li
            lat[qi] = dt
            stat_rows[qi] = np.concatenate([st, [index.n_tiles]])

    if warmup and B > 0:
        run_query(0, record=False)   # first-call set-up outside the timing
    for qi in range(B):
        run_query(qi, record=True)

    stats = dict(zip(STAT_KEYS + ("n_tiles",), stat_rows.T))
    return RetrievalResult(ids=index.to_orig(ids), scores=scores,
                           global_ids=index.to_orig(g_ids),
                           local_ids=index.to_orig(l_ids), stats=stats,
                           latencies_ms=lat)
