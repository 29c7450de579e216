"""Per-query traversal telemetry -> span attributes.

The traversal executors count the work the paper's pruning saves
(``tiles_visited``, ``chunks_dispatched``, ``n_chunks``, the doc-level
skip counters) into per-query stat arrays, already on the host as numpy
(``core.traversal``). This module turns one request's stats dict into
flat scalar span attributes, so one exported trace shows *why* a query
was slow: its own dispatched-chunk count, not just its latency.

It imports ``core.traversal`` (and so torch), so it is not re-exported
from ``repro_torch.obs``'s package root: the metrics, spans, cost and
export surface loads without torch; consumers import this module
explicitly.
"""
from __future__ import annotations

import numpy as np

from ..core.traversal import TRACE_STAT_KEYS


def request_attributes(stats: dict, reduce=np.max) -> dict:
    """Flatten a (per-request) stats dict to scalar attributes: each
    known traversal counter reduced over the request's rows (max by
    default: the row that kept the batch's chunk loop alive). Keys an
    engine does not produce (``chunks_dispatched`` on a full scan) are
    absent."""
    out = {}
    for key in TRACE_STAT_KEYS:
        v = stats.get(key)
        if v is None:
            continue
        arr = np.asarray(v, np.float64)
        if arr.size == 0 or not np.isfinite(arr).all():
            continue
        out[key] = float(reduce(arr) if arr.ndim else arr)
    return out


def row_attributes(stats: dict, row: int) -> dict:
    """Scalar traversal attributes for one row of a stats dict."""
    out = {}
    for key in TRACE_STAT_KEYS:
        v = stats.get(key)
        if v is None:
            continue
        arr = np.asarray(v, np.float64)
        if arr.ndim >= 1 and row < arr.shape[0]:
            out[key] = float(arr[row])
        elif arr.ndim == 0:
            out[key] = float(arr)
    return out
