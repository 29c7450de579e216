"""Deterministic fault injection for the serving stack.

None of the fault-tolerance machinery (deadlines, retries, breakers,
hot swap) is testable without *controllable* failures, so the scheduler
and executor pool thread every batch through a declarative
:class:`FaultPlan` hook — a no-op by default (``faults=None``), a
scripted failure schedule under test:

    plan = FaultPlan([
        fail_batch(0, executor=0),            # executor 0's first batch
        delay_route("long", 40.0, times=2),   # +40 ms on two long batches
        poison_generation(2),                 # every gen-2 batch fails
        kill_executor(1),                     # thread death, not a batch
    ])
    sched = AsyncRetrievalScheduler(index, params, cfg, faults=plan)

Two hook points:

  - ``on_batch(...)`` — called by the scheduler right before a batch
    attempt runs ``Retriever.search``. ``fail``/``poison`` faults raise
    :class:`InjectedFault` (the retry policy sees ``retryable``);
    ``delay`` faults return a *virtual* delay in ms — added to the
    latency the health monitor records — and only actually sleep when
    the plan was built with ``wall=True`` (benchmarks want real
    slowdown; tests never sleep).
  - ``on_pick(executor_id)`` — called by a pool worker at the top of
    its loop, *outside* the batch-execution protection. ``die`` faults
    raise :class:`InjectedDeath` there, unwinding the worker thread —
    the scheduler must survive and report it.

Matching is positional and deterministic: ``batch=N`` matches the Nth
batch *attempt* (0-based) — per-executor when ``executor`` is set,
global otherwise — so a retry of a failed batch is a *different*
ordinal and a ``times=1`` fault lets it through. ``plan.fired`` records
every injection for test assertions.
"""
from __future__ import annotations

import dataclasses
import threading
import time


class InjectedFault(RuntimeError):
    """A scripted batch-execution failure. ``retryable`` is what
    :meth:`~repro_torch.serve.health.RetryPolicy.retryable` reads."""

    def __init__(self, msg: str, retryable: bool = True):
        super().__init__(msg)
        self.retryable = retryable


class InjectedDeath(RuntimeError):
    """A scripted executor-thread death (raised outside batch
    execution, so no handle catches it — the pool must)."""


_KINDS = ("fail", "delay", "die", "poison")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative fault. ``None`` filters match anything; ``times``
    bounds how often it fires (``None`` = unlimited)."""
    kind: str
    executor: int | None = None    # pool slot filter
    route: str | None = None       # executed route-name filter
    batch: int | None = None       # Nth attempt (per-executor if executor
    #                                is set, else global), 0-based
    generation: int | None = None  # index-generation filter
    times: int | None = 1
    delay_ms: float = 0.0          # for kind="delay"
    retryable: bool = True         # for kind="fail"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"fault kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")


def fail_batch(batch: int | None = None, *, executor: int | None = None,
               route: str | None = None, retryable: bool = True,
               times: int | None = 1) -> Fault:
    """Fail batch attempt N (on executor E / route R) with an
    :class:`InjectedFault`."""
    return Fault("fail", executor=executor, route=route, batch=batch,
                 retryable=retryable, times=times)


def delay_route(route: str | None, delay_ms: float, *,
                executor: int | None = None,
                times: int | None = None) -> Fault:
    """Slow batches of ``route`` down by ``delay_ms`` (virtual unless
    the plan has ``wall=True``)."""
    return Fault("delay", executor=executor, route=route,
                 delay_ms=delay_ms, times=times)


def poison_generation(generation: int, *,
                      times: int | None = None) -> Fault:
    """Every batch served by index generation G fails, non-retryably —
    the 'bad rebuild' scenario the hot-swap gate must survive."""
    return Fault("poison", generation=generation, retryable=False,
                 times=times)


def kill_executor(executor: int, *, times: int | None = 1) -> Fault:
    """Unwind executor E's worker thread at its next pick."""
    return Fault("die", executor=executor, times=times)


class FaultPlan:
    """A seeded, declarative failure schedule (see module docstring).

    ``wall=True`` makes ``delay`` faults actually sleep (benchmarks);
    the default returns virtual delays only, so fault tests never touch
    the wall clock. ``fired`` is the injection log:
    ``(kind, executor_id, batch_index, route, generation)`` tuples in
    injection order — a pure function of the batch schedule, pinned by
    the determinism test.
    """

    def __init__(self, faults=(), *, seed: int = 0, wall: bool = False):
        self.faults = tuple(faults)
        self.seed = seed
        self.wall = wall
        self.fired: list[tuple] = []
        self._remaining = [f.times for f in self.faults]
        self._lock = threading.Lock()

    @staticmethod
    def _matches(f: Fault, *, executor_id, batch_index, global_index,
                 route, generation) -> bool:
        if f.executor is not None and f.executor != executor_id:
            return False
        if f.route is not None and f.route != route:
            return False
        if f.generation is not None and f.generation != generation:
            return False
        if f.batch is not None:
            ordinal = batch_index if f.executor is not None else global_index
            if f.batch != ordinal:
                return False
        return True

    def _take(self, i: int) -> bool:
        """Consume one firing of fault ``i`` (False when exhausted)."""
        left = self._remaining[i]
        if left is None:
            return True
        if left <= 0:
            return False
        self._remaining[i] = left - 1
        return True

    def on_batch(self, *, executor_id, batch_index, global_index,
                 route, generation) -> float:
        """The batch-attempt hook: may raise ``InjectedFault``; returns
        the (virtual) extra delay in ms."""
        delay = 0.0
        raise_fault = None
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.kind == "die":
                    continue
                if not self._matches(f, executor_id=executor_id,
                                     batch_index=batch_index,
                                     global_index=global_index,
                                     route=route, generation=generation):
                    continue
                if not self._take(i):
                    continue
                self.fired.append((f.kind, executor_id, batch_index,
                                   route, generation))
                if f.kind == "delay":
                    delay += f.delay_ms
                elif f.kind == "fail":
                    raise_fault = InjectedFault(
                        f"injected failure (executor {executor_id}, "
                        f"batch {batch_index}, route {route!r})",
                        retryable=f.retryable)
                    break
                elif f.kind == "poison":
                    raise_fault = InjectedFault(
                        f"injected poison (index generation {generation})",
                        retryable=f.retryable)
                    break
        if self.wall and delay > 0:
            time.sleep(delay / 1e3)
        if raise_fault is not None:
            raise raise_fault
        return delay

    def on_pick(self, *, executor_id) -> None:
        """The worker-loop hook: ``die`` faults raise InjectedDeath."""
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.kind != "die" or f.executor != executor_id:
                    continue
                if not self._take(i):
                    continue
                self.fired.append(("die", executor_id, None, None, None))
                raise InjectedDeath(
                    f"injected death of executor {executor_id}")
