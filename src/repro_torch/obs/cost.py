"""Trace-fitted chunk-count predictor for batch-sorted dispatch.

The chunked traversal's cost is its chunk loop's trip count —
``chunks_dispatched`` — and in a batch the *batch* pays the max over
its rows. Query length only coarsely predicts that count; what actually
drives it is how much bound mass the query carries.
This module closes the loop the tracer opens: execute spans carry
``(cost_features, chunks_dispatched)`` pairs, a ridge regression fits
them offline, and a scheduler sorts
each picked group by the prediction (``SchedulerConfig.
sort_batches_by_cost``) so micro-batches cluster similar-cost requests
and the max-over-batch trip count hugs the mean.

**Features** (:data:`FEATURES`, per query row, computed host-side from
the same planner inputs ``core.plan.plan_query`` sorts by — the
alpha-combined query-weighted list maxima ``combine(alpha, qwb *
sigma_b[qt], qwl * sigma_l[qt])``):

- ``n_terms``    — live (nonzero-weight) term count;
- ``ub_sum``     — total per-term upper-bound mass;
- ``ub_max``     — the single largest term bound;
- ``ub_tail``    — ``ub_sum - ub_max``: the non-essential prefix mass
  (MaxScore's non-essential side at the deepest threshold) — what keeps
  chunk bounds above theta long after the top term alone would fail;
- ``ess_ref``    — essential-set size at a fixed reference threshold
  (the corpus's largest list maximum, frozen at featurizer build): how
  many terms the ascending prefix-sum partition marks essential.

**Monotonicity by construction**: every feature is nondecreasing under
adding a term or increasing a weight (for ``ess_ref``: the sum of the
i smallest bounds is nondecreasing in every bound, and a new element
only shifts the count up), and :meth:`CostModel.fit` constrains the
ridge weights nonnegative (projected coordinate descent) — so a
heavier query can never predict fewer chunks, which the test suite
pins. Prediction is pure numpy; fitting needs nothing but numpy
either. The featurizer reads an index's tensors (on any device) to the
host once, at construction.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np

FEATURES = ("n_terms", "ub_sum", "ub_max", "ub_tail", "ess_ref")


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor (on any device) through
    ``.cpu().numpy()``, anything else through ``np.asarray``."""
    if hasattr(x, "cpu") and hasattr(x, "numpy"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class QueryFeaturizer:
    """Host-side feature extraction over one index's list maxima.

    Pulls ``sigma_b`` / ``sigma_l`` to host numpy once (tensors on any
    device, or arrays; an index with a ``sparse`` half exposes them
    through it) and evaluates
    :data:`FEATURES` for padded ``[r, width]`` query rows — a few numpy
    reductions per request, cheap enough for the submit path.
    """

    def __init__(self, index, params):
        base = getattr(index, "sparse", index)
        self.sigma_b = _host(base.sigma_b).astype(np.float32)
        self.sigma_l = _host(base.sigma_l).astype(np.float32)
        self.alpha = float(params.alpha)
        # fixed reference threshold for ess_ref: the corpus's largest
        # alpha-combined list maximum — frozen here so the feature is a
        # pure (monotone) function of the query
        combined = (self.alpha * self.sigma_b
                    + (1.0 - self.alpha) * self.sigma_l)
        self.theta_ref = float(combined.max(initial=0.0))

    def __call__(self, terms, qw_b, qw_l) -> np.ndarray:
        """Features for padded query rows: [r, len(FEATURES)] f64.
        Zero-weight padding terms contribute nothing (live mask)."""
        t = np.atleast_2d(_host(terms))
        wb = np.atleast_2d(_host(qw_b).astype(np.float64))
        wl = np.atleast_2d(_host(qw_l).astype(np.float64))
        live = (wb != 0) | (wl != 0)
        ub = (self.alpha * wb * self.sigma_b[t]
              + (1.0 - self.alpha) * wl * self.sigma_l[t])
        ub = np.where(live, np.maximum(ub, 0.0), 0.0)
        n_terms = live.sum(axis=1)
        ub_sum = ub.sum(axis=1)
        ub_max = ub.max(axis=1, initial=0.0)
        # essential count at theta_ref: terms whose ascending inclusive
        # prefix sum exceeds the reference threshold
        cum = np.cumsum(np.sort(ub, axis=1), axis=1)
        ess = (cum > self.theta_ref).sum(axis=1)
        return np.stack([n_terms, ub_sum, ub_max, ub_sum - ub_max, ess],
                        axis=1).astype(np.float64)


@dataclasses.dataclass
class CostModel:
    """Nonnegative ridge regression ``chunks ~ intercept + X @ w``.

    ``weights`` are guaranteed >= 0 by :meth:`fit`, so prediction is
    monotone in every (monotone) feature. ``predict`` clamps at 0 —
    a chunk count can't be negative; callers comparing batches only
    need the ordering anyway.
    """

    weights: np.ndarray
    intercept: float
    features: tuple = FEATURES
    r2: float = math.nan
    n_samples: int = 0

    def predict(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        if X.shape[1] != len(self.weights):
            raise ValueError(
                f"feature width {X.shape[1]} != model width "
                f"{len(self.weights)} (features {self.features})")
        return np.maximum(self.intercept + X @ self.weights, 0.0)

    @classmethod
    def fit(cls, X, y, l2: float = 1e-3, n_iter: int = 300,
            features: tuple = FEATURES) -> "CostModel":
        """Projected coordinate descent for the nonnegative ridge
        problem ``min ||y - b - Xw||^2 + l2 ||w||^2, w >= 0``. Columns
        are max-scaled internally for conditioning (a positive scale,
        so projecting to ``w >= 0`` is unchanged) and the scale is
        folded back into the returned weights."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        y = np.asarray(y, np.float64).ravel()
        if X.shape[0] != y.size:
            raise ValueError(f"{X.shape[0]} feature rows vs {y.size} targets")
        if y.size == 0:
            raise ValueError("cannot fit a cost model on zero samples")
        scale = np.abs(X).max(axis=0)
        scale[scale == 0] = 1.0
        Xs = X / scale
        w = np.zeros(Xs.shape[1])
        b = float(y.mean())
        col_sq = (Xs * Xs).sum(axis=0)
        r = y - b - Xs @ w
        for _ in range(n_iter):
            for j in range(Xs.shape[1]):
                if col_sq[j] == 0:
                    continue
                rho = Xs[:, j] @ r + col_sq[j] * w[j]
                new = max(rho / (col_sq[j] + l2), 0.0)
                if new != w[j]:
                    r += Xs[:, j] * (w[j] - new)
                    w[j] = new
            new_b = b + r.mean()
            r -= new_b - b
            b = new_b
        ss_res = float(r @ r)
        ss_tot = float(((y - y.mean()) ** 2).sum())
        r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else (
            1.0 if ss_res < 1e-12 else 0.0)
        return cls(weights=w / scale, intercept=b, features=tuple(features),
                   r2=r2, n_samples=int(y.size))

    @classmethod
    def fit_from_traces(cls, spans: list, l2: float = 1e-3) -> "CostModel":
        """Fit from a tracer export (``Tracer.export()`` dicts): every
        span carrying both ``cost_features`` and a realized
        ``chunks_dispatched`` attribute is a sample — the pairs the
        scheduler's execute spans record when tracing is enabled."""
        X, y = [], []
        for s in spans:
            attrs = s.get("attrs", s)
            f, c = attrs.get("cost_features"), attrs.get("chunks_dispatched")
            if f is None or c is None:
                continue
            X.append(np.asarray(f, np.float64))
            y.append(float(c))
        if not y:
            raise ValueError(
                "no (cost_features, chunks_dispatched) samples in the "
                "trace export — run with tracing enabled on a chunked-"
                "traversal route first")
        return cls.fit(np.stack(X), np.asarray(y), l2=l2)

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"features": list(self.features),
                "weights": [float(w) for w in self.weights],
                "intercept": float(self.intercept),
                "r2": float(self.r2), "n_samples": self.n_samples}

    def save(self, path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path) -> "CostModel":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(weights=np.asarray(d["weights"], np.float64),
                   intercept=float(d["intercept"]),
                   features=tuple(d["features"]),
                   r2=float(d.get("r2", math.nan)),
                   n_samples=int(d.get("n_samples", 0)))
