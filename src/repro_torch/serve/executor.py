"""Executor pool: N concurrent batch executors over one scheduler.

The layer between :meth:`AsyncRetrievalScheduler._pick_batch` and batch
execution. Each executor is a worker thread holding its **own
Retriever replica per route** (``Retriever.replicate()``: a fresh
engine instance sharing the scheduler's one copy of the index on its
device — no rebuild, no copy) and, when the device is CUDA, **its own
CUDA stream**, pulling picked micro-batches concurrently from the
scheduler's (k-bucket x length-class) group queues. The scheduler stays
the single source of truth: admission, grouping, deadlines, the response
cache, and every counter live behind its lock; executors only race on
*pick* (serialized by that same lock) and then run ``Retriever.search``
outside it.

Why replicas at all, when the kernel libraries and the allocator are
process-wide? They are shared — one warmup pass warms the whole routing
grid for every executor at once — but the *Python* dispatch path
(engine objects, per-call state) is not designed for concurrent reuse;
a replica per worker makes each batch's host-side path private by
construction instead of by audit.

Streams: a worker runs its loop under ``torch.cuda.stream(s)`` with its
slot's stream ``s``. Current streams are per thread, so every launch of
its batches — the port's kernels launch on the current stream, and so do
PyTorch's — goes to ``s``, and the batches of two slots overlap on the
card as far as their host threads let them. Before a slot's first batch
of an index generation, ``s`` waits on the stream that moved that
generation's index to the card (``AsyncRetrievalScheduler.
_resolve_retriever``). Results reach the host through ``.cpu()``, which
waits for ``s`` only. A hedged loser runs to its end on its own stream
and its result is dropped. On the CPU there are no streams.

Lifecycle: ``start()`` warms the full (route x k-bucket) grid via
:meth:`AsyncRetrievalScheduler.warmup`, pre-builds every slot's replica
map, then spawns the workers. ``close(drain=True)`` flips the stop
flag and lets the executors themselves drain the group queues before
exiting — close-time backlog still runs on all N replicas
concurrently, and every outstanding ``SearchHandle`` resolves before
``close`` returns.

Fault tolerance hooks (``serve.health`` / ``serve.faults``): before
picking, a worker consults its circuit breaker
(``scheduler.health.allow``) — an open breaker idles the slot until
its half-open probe is due — and the fault plan's ``on_pick`` (a
scripted ``die`` fault unwinds the thread here, *outside* batch
execution). A worker that dies this way is reported to the scheduler
(``executor_deaths`` / ``dead_executors`` in ``stats()``) and its
breaker goes terminally dead; the remaining workers keep serving.
When the queue is idle, a worker hedges straggler batches running on
*other* slots (``scheduler.hedge_due``) — first result wins. Replica
maps are generation-tagged (:class:`ReplicaMap`): after an index
hot-swap, the next resolve clears and rebuilds them from the new
masters, so the flip needs no pool restart.

Determinism: N executors produce bit-identical responses to the
single-worker path. A picked batch is an ordered list of whole
requests executed in one ``search`` call; which *replica* (or stream)
runs it cannot change its result (same kernels, same index tensors),
and the response cache stores per-request slices keyed on content, not
on arrival interleaving.
"""
from __future__ import annotations

import threading
import time

import torch


class ReplicaMap(dict):
    """One slot's {route_name: Retriever replica} map, tagged with the
    index generation it was replicated from. The scheduler's
    ``_resolve_retriever`` clears + rebuilds a map whose generation
    trails the installed index — the lazy half of the hot-swap gate.
    ``stream`` is the slot's CUDA stream (None on the CPU);
    ``ready_generation`` the last generation whose index upload it
    waited for."""

    def __init__(self, *args, generation: int = 0, stream=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.generation = generation
        self.stream = stream
        self.ready_generation = -1


class ExecutorPool:
    """N worker threads executing a scheduler's picked micro-batches.

    Built (and owned) by :meth:`AsyncRetrievalScheduler.start` when
    ``SchedulerConfig.executors > 0``; usable standalone in tests via
    ``ExecutorPool(scheduler, n).start()``.
    """

    def __init__(self, scheduler, n_executors: int, *,
                 warmup: bool = True):
        if n_executors < 1:
            raise ValueError(
                f"an ExecutorPool needs >= 1 executors, got {n_executors}")
        self.scheduler = scheduler
        self.n_executors = n_executors
        self._do_warmup = warmup
        self._threads: list[threading.Thread] = []
        # slot -> ReplicaMap (with the slot's stream on CUDA); built at
        # start() so the first picked batch never pays replication,
        # extended lazily by _execute if a route first appears after
        # start, rebuilt after an index hot-swap
        self.replicas: dict[int, ReplicaMap] = {}
        self._stop = False
        self._drain = True

    def is_running(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def start(self) -> "ExecutorPool":
        """Warm the routing grid, build per-slot replicas (and streams,
        on CUDA), spawn workers (idempotent while running)."""
        if self.is_running():
            return self
        sched = self.scheduler
        if self._do_warmup:
            sched.warmup()
        for slot in range(self.n_executors):
            self.replicas[slot] = ReplicaMap(
                {r.name: sched._retriever(r.name).replicate()
                 for r in sched.routing.all_routes},
                generation=sched.generation,
                stream=(torch.cuda.Stream(sched.device)
                        if sched.device.type == "cuda" else None))
        self._stop = False
        self._drain = True
        self._threads = [
            threading.Thread(target=self._run, args=(slot,),
                             name=f"retrieval-executor-{slot}", daemon=True)
            for slot in range(self.n_executors)]
        for t in self._threads:
            t.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the workers. ``drain=True`` (default) has them empty the
        group queues first — deadlines are waived, every pending request
        executes, all handles resolve — before the threads exit."""
        sched = self.scheduler
        with sched._cond:
            self._stop = True
            self._drain = drain
            sched._cond.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []

    def swap_index(self, index, params=None, *, warm: bool = True) -> int:
        """Install a rebuilt index as a new generation without stopping
        the pool — delegates to
        :meth:`AsyncRetrievalScheduler.swap_index` (warm the new grid,
        flip masters between batches); each slot's :class:`ReplicaMap`
        rebuilds itself on its next resolve."""
        return self.scheduler.swap_index(index, params, warm=warm)

    def _run(self, slot: int) -> None:
        """One executor's loop (see :meth:`_serve`), on the slot's stream:
        any escape that is not a normal return is a thread death
        *outside* batch execution — no handle is stranded by it, but the
        operator must see it."""
        try:
            with torch.cuda.stream(self.replicas[slot].stream):
                self._serve(slot)
        except BaseException as exc:  # noqa: BLE001 — liveness accounting
            self.scheduler._record_executor_death(slot, exc)

    def _serve(self, slot: int) -> None:
        """Pick a due batch (under the scheduler lock), execute it on
        this slot's replicas (outside it), repeat; when idle, hedge a
        straggler batch from another slot or park on the condition
        until the next deadline. A slot whose breaker is open idles
        until its half-open probe is due (drain waives the gate so
        ``close`` can never hang on a broken breaker)."""
        sched = self.scheduler
        retrievers = self.replicas[slot]
        while True:
            force = False
            with sched._cond:
                if self._stop:
                    if not self._drain or not sched._groups:
                        return
                    force = True   # drain: waive deadlines, take the rest
            if sched.faults is not None:
                # the scripted-death hook: outside _execute's failure
                # delivery, so a raise here unwinds the worker itself
                sched.faults.on_pick(executor_id=slot)
            now = time.perf_counter()
            if not force and not sched.health.allow(slot, now):
                with sched._cond:
                    sched._cond.wait(timeout=0.01)
                continue
            picked = sched._pick_batch(now, force)
            if picked is None:
                # idle: volunteer as the hedge executor for straggler
                # batches whose primary is another slot
                hedged = 0
                for token in sched.hedge_due(now=now,
                                             exclude_executor=slot):
                    hedged += 1
                    try:
                        sched._run_attempt(token, retrievers=retrievers,
                                           executor_id=slot)
                    except Exception:
                        # failed attempts resolve their own handles
                        pass
                if hedged:
                    continue
                with sched._cond:
                    if self._stop:
                        if not self._drain or not sched._groups:
                            return
                        continue   # another slot is mid-pick; retry
                    deadlines = [max(e.deadline, e.not_before)
                                 for g in sched._groups.values() for e in g]
                    wait = 0.05
                    if deadlines:
                        wait = min(wait, min(deadlines) -
                                   time.perf_counter())
                    sched._cond.wait(timeout=max(wait, 1e-3))
                continue
            t_exec = time.perf_counter()
            try:
                sched._execute(*picked, retrievers=retrievers,
                               executor_id=slot)
            except Exception:
                # the batch's handles were already failed by _execute;
                # this executor must keep serving everyone else
                pass
            finally:
                # wall time this slot spent executing (success or not) —
                # the per-executor utilization signal next to the
                # scheduler's delivery-side batch_service_ms
                sched.metrics.histogram("executor_service_ms").record(
                    (time.perf_counter() - t_exec) * 1e3)
