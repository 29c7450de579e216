"""2GTI parameterization (paper Section 4.1) and method presets.

Three hybrid scores per document, accumulated incrementally:

    Global(d)    = alpha * S_B(d) + (1-alpha) * S_L(d)   -- drives global pruning
    Local(d)     = beta  * S_B(d) + (1-beta)  * S_L(d)   -- drives local pruning
    RankScore(d) = gamma * S_B(d) + (1-gamma) * S_L(d)   -- final ranking

with three independent top-k queues / dynamic thresholds. Special cases:
GTI  = 2GTI(alpha=beta=1);  GT = GTI with gamma=0;
plain MaxScore on learned weights = 2GTI(alpha=beta=gamma=0).
``threshold_factor`` multiplies theta_Gl/theta_Lo at pruning time only
(>1 = rank-unsafe over-estimation, <1 = under-estimation; Table 3 / Fig. 3).
``bound_mode``: 'list' uses list-level maxima for term partitioning and local
bounds (paper MaxScore); 'tile' uses tile-level (block-max) maxima — the
Appendix-B/BMW-style tightening, the default for the optimized
configuration.

Retrieval depth ``k`` is a *query-time* quantity, not a pruning policy:
it lives in the request path (``repro_torch.retrieval.SearchRequest.k`` or the
``k=`` argument of the retrieve entry points). ``TwoLevelParams`` still
accepts ``k=`` as a deprecation shim — the value is stashed outside the
dataclass fields (it does not participate in equality/hash) and is used
as a fallback by ``resolve_k`` when a call site passes no depth.
"""
from __future__ import annotations

import dataclasses
import warnings

BOUND_MODES = ("list", "tile")
SCHEDULES = ("docid", "impact")

# Fallback retrieval depth when neither the call site nor a legacy
# TwoLevelParams(k=...) stash provides one.
DEFAULT_K = 10


def _warn_k_deprecated() -> None:
    warnings.warn(
        "TwoLevelParams.k is deprecated: retrieval depth is a query-time "
        "argument now. Pass k per call (Retriever.search(..., k=...) / "
        "SearchRequest.k / retrieve_*(..., k=...)).",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True, init=False)
class TwoLevelParams:
    alpha: float = 1.0
    beta: float = 0.3
    gamma: float = 0.05
    threshold_factor: float = 1.0
    bound_mode: str = "list"
    # Tile visitation order. 'docid' mirrors DAAT (paper-faithful);
    # 'impact' visits tiles in descending global upper bound — thresholds
    # tighten fastest and traversal can stop at the first bound-failing
    # tile (beyond-paper, score-at-a-time flavored; still bound-safe).
    schedule: str = "docid"
    # Tiles per dispatch chunk for the ``traversal="chunked"`` executors:
    # the descending-bound tile order is folded into static groups of this
    # size and the chunk loop exits at the first bound-failing chunk
    # (Block-Max-Pruning structure). Only read by chunked traversal.
    chunk_tiles: int = 8

    # ``k`` keeps its historical positional slot so pre-deprecation call
    # sites (including positional ones) stay bit-compatible.
    def __init__(self, alpha: float = 1.0, beta: float = 0.3,
                 gamma: float = 0.05, k: int | None = None,
                 threshold_factor: float = 1.0, bound_mode: str = "list",
                 schedule: str = "docid", chunk_tiles: int = 8):
        object.__setattr__(self, "alpha", alpha)
        object.__setattr__(self, "beta", beta)
        object.__setattr__(self, "gamma", gamma)
        object.__setattr__(self, "threshold_factor", threshold_factor)
        object.__setattr__(self, "bound_mode", bound_mode)
        object.__setattr__(self, "schedule", schedule)
        object.__setattr__(self, "chunk_tiles", chunk_tiles)
        if k is not None:
            _warn_k_deprecated()
            k = int(k)
        object.__setattr__(self, "_legacy_k", k)
        self.__post_init__()

    def __post_init__(self):
        if self.bound_mode not in BOUND_MODES:
            raise ValueError(f"bound_mode must be in {BOUND_MODES}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be in {SCHEDULES}")
        if self.chunk_tiles < 1:
            raise ValueError(f"chunk_tiles={self.chunk_tiles} must be >= 1")
        for name in ("alpha", "beta", "gamma"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} outside [0, 1]")

    @property
    def k(self) -> int:
        """Deprecated fallback depth: the legacy stash, else DEFAULT_K."""
        lk = getattr(self, "_legacy_k", None)
        return lk if lk is not None else DEFAULT_K

    def replace(self, **kw) -> "TwoLevelParams":
        if "k" in kw:
            k = kw.pop("k")
            if k is not None:
                _warn_k_deprecated()
                k = int(k)
        else:
            k = getattr(self, "_legacy_k", None)
        new = dataclasses.replace(self, **kw)
        object.__setattr__(new, "_legacy_k", k)
        return new


def resolve_k(params: TwoLevelParams | None, k: int | None = None) -> int:
    """Retrieval depth for one call: explicit ``k`` > legacy params stash
    > DEFAULT_K. The single place the deprecation shim is consulted."""
    if k is not None:
        return int(k)
    lk = getattr(params, "_legacy_k", None) if params is not None else None
    return int(lk) if lk is not None else DEFAULT_K


def original(k: int | None = None, gamma: float = 0.0, **kw) -> TwoLevelParams:
    """Plain MaxScore on the gamma-combined score (alpha=beta=gamma)."""
    return TwoLevelParams(alpha=gamma, beta=gamma, gamma=gamma, k=k, **kw)


def gt(k: int | None = None, **kw) -> TwoLevelParams:
    """GT: BM25-guided pruning, learned-only final ranking."""
    return TwoLevelParams(alpha=1.0, beta=1.0, gamma=0.0, k=k, **kw)


def gti(k: int | None = None, gamma: float = 0.05, **kw) -> TwoLevelParams:
    """GTI: BM25-guided pruning, interpolated final ranking."""
    return TwoLevelParams(alpha=1.0, beta=1.0, gamma=gamma, k=k, **kw)


def accurate(k: int | None = None, gamma: float = 0.05, **kw) -> TwoLevelParams:
    """2GTI-Accurate: beta=0 (learned-only local pruning)."""
    return TwoLevelParams(alpha=1.0, beta=0.0, gamma=gamma, k=k, **kw)


def fast(k: int | None = None, beta: float = 0.3, gamma: float = 0.05,
         **kw) -> TwoLevelParams:
    """2GTI-Fast: small-but-nonzero beta."""
    return TwoLevelParams(alpha=1.0, beta=beta, gamma=gamma, k=k, **kw)


def linear_combination(k: int | None = None, gamma: float = 0.05,
                       **kw) -> TwoLevelParams:
    """Rank-safe MaxScore over the linear combination (alpha=beta=gamma=g)."""
    return TwoLevelParams(alpha=gamma, beta=gamma, gamma=gamma, k=k, **kw)
