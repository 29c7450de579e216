"""Quantiles.

``exact_quantile`` is a copy of ``repro_torch.obs.metrics.exact_quantile``
(nearest rank: an observed sample, never an interpolation), kept here so
that later changes to the program cannot move the yardstick.
"""
from __future__ import annotations

import math

import numpy as np


def exact_quantile(samples, q: float) -> float:
    """Nearest-rank quantile: ``sorted(x)[ceil(q * n) - 1]``; non-finite
    entries dropped, NaN for an empty sample, ``q`` clamped to (0, 1]."""
    x = np.asarray(samples, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    if x.size == 0:
        return math.nan
    rank = min(max(int(math.ceil(q * x.size)), 1), int(x.size))
    return float(np.sort(x)[rank - 1])

