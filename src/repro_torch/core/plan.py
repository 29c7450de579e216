"""Query planner for the 2GTI tile scan: the planner/executor contract.

Planner responsibilities (this module):
  - **term ordering**: ``plan_query`` presorts query terms ascending by
    alpha-combined list maxima and packages the weighted list maxima
    (``sig_b``/``sig_l``) alongside, as a :class:`QueryPlan`;
  - **tile scheduling**: ``tile_upper_bounds`` gives the per-tile
    alpha-combined global upper bound (the tile-skip test operand),
    ``tile_schedule`` turns it into a visit order (``docid`` or
    ``impact``) and ``chunk_schedule`` folds the impact order into chunks;
  - **per-tile term bounds**: ``term_bounds`` yields ``(m_alpha, m_beta,
    ub_gl)`` under either ``bound_mode`` (``list`` = MaxScore list maxima,
    ``tile`` = block-max tightening);
  - **threshold partitioning**: ``essential_terms`` marks the essential
    suffix given theta_Gl, ``freeze_bounds`` gives the inclusive beta-bound
    prefix sums driving the local freeze test.

Executors (``core.traversal`` / ``kernels.guided_score``) only gather,
scatter-accumulate and merge queues.

Every function takes a leading batch dimension over queries (``[B, Nq]``
plans) where the reference maps one query at a time. Coefficients
(``alpha``, ``beta``, ...) are float32 values held as Python floats, so
the arithmetic rounds in float32. Sorts are stable, as ``argsort`` is in
the reference: the chunked scan's bit-identity with the impact scan
depends on the same tie order. Sums over the query terms add left to right
in float32 (``_seq_cumsum``), the order the reference uses on the CPU;
``torch.cumsum`` accumulates in double on the CPU and in a parallel scan
on the GPU, and ``torch.sum`` reorders too, which moves the bounds by an
ulp and can flip a skip or freeze decision.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _seq_cumsum(x):
    """Inclusive prefix sums along the last dim, added left to right in
    float32."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def _seq_sum(x, dim: int):
    """Sum along ``dim``, added left to right in float32."""
    x = x.movedim(dim, 0)
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def combine(coef, b, l):
    """The paper's two-weight interpolation: coef * B + (1 - coef) * L."""
    return coef * b + (1.0 - coef) * l


class QueryPlan(NamedTuple):
    """Per-query traversal plans, batched: terms presorted ascending by
    alpha-combined list maxima (the MaxScore partition order)."""
    qt: torch.Tensor     # [B, Nq] int32 term ids, sorted order
    qwb: torch.Tensor    # [B, Nq] f32 BM25-side query weights, sorted order
    qwl: torch.Tensor    # [B, Nq] f32 learned-side query weights, sorted order
    sig_b: torch.Tensor  # [B, Nq] f32 query-weighted list maxima (BM25 side)
    sig_l: torch.Tensor  # [B, Nq] f32 query-weighted list maxima (learned)


def plan_query(qt, qwb, qwl, sigma_b, sigma_l, alpha) -> QueryPlan:
    """Sort each row's query terms ascending by alpha-combined list maxima."""
    sig_b = qwb * sigma_b[qt.long()]
    sig_l = qwl * sigma_l[qt.long()]
    order = torch.argsort(combine(alpha, sig_b, sig_l), dim=-1, stable=True)

    def take(x):
        return torch.gather(x, -1, order)
    return QueryPlan(take(qt), take(qwb), take(qwl), take(sig_b),
                     take(sig_l))


def tile_upper_bounds(plan: QueryPlan, tile_max_b, tile_max_l, alpha):
    """Per-tile alpha-combined global upper bounds: [B, n_tiles]."""
    qt = plan.qt.long()
    tm_b = plan.qwb[..., None] * tile_max_b[qt]
    tm_l = plan.qwl[..., None] * tile_max_l[qt]
    return _seq_sum(combine(alpha, tm_b, tm_l), -2)


def tile_schedule(plan: QueryPlan, tile_max_b, tile_max_l, alpha,
                  n_tiles: int, schedule: str):
    """Tile visit order, [B, n_tiles] int32. ``docid`` mirrors DAAT;
    ``impact`` visits tiles in descending global upper bound so thresholds
    tighten fastest."""
    if schedule == "impact":
        ub = tile_upper_bounds(plan, tile_max_b, tile_max_l, alpha)
        return torch.argsort(-ub, dim=-1, stable=True).to(torch.int32)
    b = plan.qt.shape[0]
    return torch.arange(n_tiles, dtype=torch.int32,
                        device=plan.qt.device).expand(b, n_tiles)


class ChunkSchedule(NamedTuple):
    """Descending-bound tile order folded into fixed-size chunks: the
    Block-Max-Pruning visit structure (process blocks in descending bound
    order, stop when the next bound clears the threshold)."""
    chunks: torch.Tensor    # [B, n_chunks, chunk_tiles] int32 tile ids; the
    #                         sentinel ``n_tiles`` pads the tail chunk and is
    #                         force-skipped by the executor
    chunk_ub: torch.Tensor  # [B, n_chunks] f32 max tile upper bound per
    #                         chunk (-inf for all-padding chunks): the
    #                         early-exit test operand. Descending.


def chunk_schedule(plan: QueryPlan, tile_max_b, tile_max_l, alpha,
                   n_tiles: int, chunk_tiles: int,
                   n_real: int | None = None) -> ChunkSchedule:
    """Chunked visit order: sort tiles by descending global upper bound and
    pad into ``[n_chunks, chunk_tiles]`` groups per query.

    Because tiles are sorted descending, the per-chunk max bound is the
    bound of the chunk's first tile, and ``chunk_ub`` is itself descending,
    so the first chunk whose bound fails the theta_Gl test proves every
    later tile fails it too.

    ``n_real``: tiles with id >= n_real are shape padding; their bound is
    forced to -inf so they sort last and never keep the chunk loop alive.
    The sentinel id ``n_tiles`` pads the ragged tail.
    """
    ub = tile_upper_bounds(plan, tile_max_b, tile_max_l, alpha)
    dev = ub.device
    if n_real is not None:
        real = torch.arange(n_tiles, device=dev) < n_real
        ub = torch.where(real, ub, -torch.inf)
    # Same expression as the ``impact`` tile_schedule: identical tie-break
    # order, which is what makes the chunked scan bit-identical to it.
    order = torch.argsort(-ub, dim=-1, stable=True).to(torch.int32)
    ub_sorted = torch.gather(ub, -1, order.long())
    b = ub.shape[0]
    n_chunks = -(-n_tiles // chunk_tiles)
    pad = n_chunks * chunk_tiles - n_tiles
    if pad:
        order = torch.cat([order, torch.full((b, pad), n_tiles,
                                             dtype=torch.int32, device=dev)],
                          -1)
        ub_sorted = torch.cat([ub_sorted, torch.full((b, pad), -torch.inf,
                                                     device=dev)], -1)
    chunks = order.reshape(b, n_chunks, chunk_tiles)
    return ChunkSchedule(chunks,
                         ub_sorted.reshape(b, n_chunks, chunk_tiles).amax(-1))


def term_bounds(plan: QueryPlan, tile_max_b, tile_max_l, tile,
                alpha, beta, bound_mode: str):
    """Bounds for tile visits: per-term maxima under both combinations
    plus each tile's global upper bound (the skip-test operand).

    ``tile`` is ``[B]`` (one tile per query) or ``[B, C]`` (a chunk);
    results are ``[..., Nq]``, ``[..., Nq]`` and ``[...]``. Tile ids past
    the last tile (the chunk sentinel) read the last tile's maxima, as the
    reference's clamped gather does; the executor force-skips them.

    ``bound_mode='list'`` partitions with list-level maxima (paper
    MaxScore); ``'tile'`` with the tile-level block maxima.
    """
    n_tiles = tile_max_b.shape[1]
    extra = tile.dim() - 1                      # 0 for [B], 1 for [B, C]
    lead = (slice(None),) + (None,) * extra

    def per_row(x):                             # [B, Nq] -> [B, (C,) Nq]
        return x[lead]
    qt = per_row(plan.qt.long())
    t = tile.long().clamp(max=n_tiles - 1)[..., None]
    tm_b = per_row(plan.qwb) * tile_max_b[qt, t]
    tm_l = per_row(plan.qwl) * tile_max_l[qt, t]
    ub_gl = _seq_sum(combine(alpha, tm_b, tm_l), -1)
    if bound_mode == "tile":
        m_alpha = combine(alpha, tm_b, tm_l)
        m_beta = combine(beta, tm_b, tm_l)
    else:
        m_alpha = combine(alpha, per_row(plan.sig_b), per_row(plan.sig_l))
        m_beta = combine(beta, per_row(plan.sig_b), per_row(plan.sig_l))
        m_alpha = m_alpha.expand_as(tm_b)
        m_beta = m_beta.expand_as(tm_b)
    return m_alpha, m_beta, ub_gl


def essential_terms(m_alpha, th_gl):
    """Global-level term partition: the suffix whose inclusive prefix bound
    exceeds theta_Gl is essential (bool, sorted term order). ``th_gl``
    broadcasts against ``m_alpha``'s leading dims."""
    return _seq_cumsum(m_alpha) > th_gl[..., None]


def freeze_bounds(m_beta):
    """Inclusive prefix sums of the beta-combined bounds: the remaining
    upper bound used by the local freeze test before each term."""
    return _seq_cumsum(m_beta)
