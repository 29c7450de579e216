"""Straggler detection and work rebalancing for synchronous data parallelism.

A copy of ``repro.dist.straggler`` (numpy only), so that the port imports
nothing of the JAX package.

The monitor keeps a per-worker EWMA of reported step times. A worker whose
EWMA exceeds ``slow_factor`` x the fleet median for ``patience`` consecutive
reports is *degraded*: its microbatch assignment is halved and the freed
microbatches move to the fastest healthy workers (total work is conserved,
so the global batch — and therefore the training trajectory — is
unchanged; only the per-worker split moves). A worker that stays degraded
for ``evict_after`` consecutive reports is signalled for eviction, the
hand-off point to the elastic trainer restart path (checkpoint + resume
with one fewer worker).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    patience: int = 3           # consecutive slow reports before degraded
    evict_after: int = 100      # consecutive degraded reports before evict
    slow_factor: float = 1.5    # EWMA threshold vs fleet median
    ewma_decay: float = 0.6     # weight on history (0 = last report only)


class StragglerMonitor:
    def __init__(self, n_workers: int, microbatches_per_worker: int,
                 cfg: StragglerConfig = StragglerConfig()):
        self.n_workers = n_workers
        self.mpw = microbatches_per_worker
        self.cfg = cfg
        self.ewma = np.zeros(n_workers, np.float64)
        self.slow_streak = np.zeros(n_workers, np.int64)
        self.degraded_streak = np.zeros(n_workers, np.int64)
        self.degraded = np.zeros(n_workers, bool)
        self.n_reports = 0

    def report(self, step: int, durations) -> dict:
        """Ingest one step's per-worker durations; returns the new
        assignment plan: {"assignments", "evict", "ewma", "degraded"}."""
        d = np.asarray(durations, np.float64)
        if self.n_reports == 0:
            self.ewma = d.copy()
        else:
            a = self.cfg.ewma_decay
            self.ewma = a * self.ewma + (1.0 - a) * d
        self.n_reports += 1

        median = float(np.median(self.ewma))
        slow = self.ewma > self.cfg.slow_factor * max(median, 1e-12)
        self.slow_streak = np.where(slow, self.slow_streak + 1, 0)
        self.degraded = self.slow_streak >= self.cfg.patience
        self.degraded_streak = np.where(self.degraded,
                                        self.degraded_streak + 1, 0)
        evict = np.nonzero(self.degraded_streak >= self.cfg.evict_after)[0]

        assignments = np.full(self.n_workers, self.mpw, np.int64)
        assignments[self.degraded] = max(self.mpw // 2, 1)
        freed = self.mpw * self.n_workers - int(assignments.sum())
        if freed > 0:
            healthy = np.nonzero(~self.degraded)[0]
            if len(healthy):
                # fastest healthy workers absorb the slack, round-robin
                order = healthy[np.argsort(self.ewma[healthy],
                                           kind="stable")]
                for i in range(freed):
                    assignments[order[i % len(order)]] += 1
            else:  # everyone degraded: keep the original split
                assignments[:] = self.mpw
        return {"assignments": assignments, "evict": evict.tolist(),
                "ewma": self.ewma.copy(), "degraded": self.degraded.copy()}
