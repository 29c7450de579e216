"""Executor health: retry policy, EWMA latency, per-executor breakers.

Fault *handling* for the serving pool (fault *injection* lives in
``serve.faults``). Three pieces:

  - :class:`RetryPolicy` — declarative per-route (or scheduler-default)
    retry behavior for failed batch executions: bounded attempts,
    exponential backoff with **deterministic seeded jitter** (the same
    (seed, request, attempt) always backs off by the same amount, so
    retry schedules are reproducible in tests and across replays), and
    a retryability predicate (transient faults requeue, poison faults
    fail fast).
  - :class:`HealthMonitor` — per-executor EWMA service latency (the
    ``dist.straggler`` shape: weight ``ewma_decay`` on history) plus
    consecutive-failure counts, and a ring of recent latencies for the
    hedge-delay percentile.
  - the **circuit breaker** per executor: ``closed`` (in rotation) ->
    ``open`` after ``failure_threshold`` consecutive failures (the
    executor stops picking batches) -> ``half_open`` after
    ``cooldown_ms`` (one probe batch is allowed through; a lost probe
    self-heals after another cooldown) -> ``closed`` on probe success /
    back to ``open`` on probe failure. ``dead`` is terminal: an
    executor whose *thread* died (reported by the pool) never re-enters
    rotation.

Every method takes an explicit ``now`` (``time.perf_counter`` scale) so
breaker transitions are drivable on a simulated clock — none of the
fault-injection tests sleep.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque

import numpy as np

from ..obs.metrics import exact_quantile

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
BREAKER_DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry behavior for failed batch executions.

    ``max_attempts`` counts the first execution: ``max_attempts=3``
    means up to two requeues. Backoff for the retry after attempt ``a``
    is ``backoff_ms * backoff_factor**(a-1)``, jittered by a
    deterministic ``+- jitter`` fraction drawn from
    ``default_rng((seed, token, a))`` — no shared RNG state, so the
    schedule is a pure function of (policy, request, attempt).
    """
    max_attempts: int = 3
    backoff_ms: float = 10.0
    backoff_factor: float = 2.0
    jitter: float = 0.5          # +- fraction of the base backoff
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.backoff_ms < 0 or self.backoff_factor < 1:
            raise ValueError("backoff_ms must be >= 0 and "
                             "backoff_factor >= 1")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay_ms(self, attempt: int, token: int = 0) -> float:
        """Backoff before the retry that follows failed ``attempt``
        (1-based). Deterministic in (seed, token, attempt)."""
        base = self.backoff_ms * self.backoff_factor ** max(attempt - 1, 0)
        if self.jitter <= 0 or base <= 0:
            return base
        u = np.random.default_rng(
            (self.seed, int(token), int(attempt))).random()
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    @staticmethod
    def retryable(exc: BaseException) -> bool:
        """Transient faults requeue; anything marked non-retryable (or
        plainly deterministic, like a ValueError from bad input) fails
        the handles immediately. The escape hatch is the exception's own
        ``retryable`` attribute (``serve.faults.InjectedFault`` sets
        it); otherwise timeouts and connection-flavored OS errors count
        as transient."""
        flag = getattr(exc, "retryable", None)
        if flag is not None:
            return bool(flag)
        return isinstance(exc, (TimeoutError, ConnectionError))


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    failure_threshold: int = 3   # consecutive failures -> breaker opens
    cooldown_ms: float = 250.0   # open -> half-open probe delay
    ewma_decay: float = 0.6      # weight on history (straggler shape)
    window: int = 256            # recent latencies kept for percentiles


class _ExecutorHealth:
    __slots__ = ("state", "ewma_ms", "n_reports", "consecutive_failures",
                 "failures", "successes", "opened_at", "probe_at")

    def __init__(self):
        self.state = BREAKER_CLOSED
        self.ewma_ms = 0.0
        self.n_reports = 0
        self.consecutive_failures = 0
        self.failures = 0
        self.successes = 0
        self.opened_at = -math.inf
        self.probe_at = -math.inf


class HealthMonitor:
    """Per-executor EWMA latency + consecutive failures + breaker state.

    Executors register lazily (the first ``record_*``/``allow`` call for
    an id creates its entry), so the monitor needs no fixed pool size.
    Thread-safe; every transition is driven by an explicit ``now``.
    """

    def __init__(self, cfg: HealthConfig | None = None):
        self.cfg = cfg if cfg is not None else HealthConfig()
        self._execs: dict[int, _ExecutorHealth] = {}
        self._latencies: deque = deque(maxlen=self.cfg.window)
        self._lock = threading.Lock()

    def _get(self, executor_id: int) -> _ExecutorHealth:
        h = self._execs.get(executor_id)
        if h is None:
            h = self._execs[executor_id] = _ExecutorHealth()
        return h

    # -- reporting -----------------------------------------------------------

    def record_success(self, executor_id: int, latency_ms: float,
                       now: float) -> None:
        with self._lock:
            h = self._get(executor_id)
            if h.state == BREAKER_DEAD:
                return
            a = self.cfg.ewma_decay
            h.ewma_ms = (latency_ms if h.n_reports == 0
                         else a * h.ewma_ms + (1.0 - a) * latency_ms)
            h.n_reports += 1
            h.successes += 1
            h.consecutive_failures = 0
            if h.state in (BREAKER_OPEN, BREAKER_HALF_OPEN):
                h.state = BREAKER_CLOSED   # probe succeeded: close
            self._latencies.append(float(latency_ms))

    def record_failure(self, executor_id: int, now: float) -> None:
        with self._lock:
            h = self._get(executor_id)
            if h.state == BREAKER_DEAD:
                return
            h.failures += 1
            h.consecutive_failures += 1
            if h.state == BREAKER_HALF_OPEN:
                # failed probe: back to open, restart the cooldown
                h.state = BREAKER_OPEN
                h.opened_at = now
            elif (h.state == BREAKER_CLOSED
                  and h.consecutive_failures >= self.cfg.failure_threshold):
                h.state = BREAKER_OPEN
                h.opened_at = now

    def mark_dead(self, executor_id: int) -> None:
        """Terminal: the executor's thread died. Never re-enters
        rotation (``allow`` is permanently False; the pool is degraded
        until replaced)."""
        with self._lock:
            self._get(executor_id).state = BREAKER_DEAD

    # -- gating --------------------------------------------------------------

    def allow(self, executor_id: int, now: float) -> bool:
        """May this executor pick a batch at ``now``? Closed: yes.
        Open: no, until ``cooldown_ms`` passes — then one half-open
        probe is let through. A probe that never reports back (e.g. the
        queue was empty) self-heals: another probe is allowed one
        cooldown later."""
        with self._lock:
            h = self._get(executor_id)
            if h.state == BREAKER_CLOSED:
                return True
            if h.state == BREAKER_DEAD:
                return False
            cool = self.cfg.cooldown_ms / 1e3
            if h.state == BREAKER_OPEN:
                if now - h.opened_at >= cool:
                    h.state = BREAKER_HALF_OPEN
                    h.probe_at = now
                    return True
                return False
            # half-open: one probe outstanding; re-arm if it got lost
            if now - h.probe_at >= cool:
                h.probe_at = now
                return True
            return False

    def degraded(self) -> bool:
        """True while any executor's breaker is not closed — the signal
        the scheduler uses to rewrite routes to their fallback lane."""
        with self._lock:
            return any(h.state != BREAKER_CLOSED
                       for h in self._execs.values())

    def state(self, executor_id: int) -> str:
        with self._lock:
            h = self._execs.get(executor_id)
            return h.state if h is not None else BREAKER_CLOSED

    # -- hedge delay ---------------------------------------------------------

    def latency_p99_ms(self, default: float = 0.0) -> float:
        """P99 over the recent-latency window (across executors), or
        ``default`` with no samples — the hedge-delay source. Exact-rank
        (a latency an attempt actually took), not interpolated."""
        with self._lock:
            if not self._latencies:
                return default
            return exact_quantile(self._latencies, 0.99)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Detached per-executor view: breaker state, EWMA latency,
        failure counters — what ``scheduler.stats()`` surfaces."""
        with self._lock:
            return {
                eid: {"state": h.state, "ewma_ms": round(h.ewma_ms, 3),
                      "consecutive_failures": h.consecutive_failures,
                      "failures": h.failures, "successes": h.successes}
                for eid, h in sorted(self._execs.items())}
