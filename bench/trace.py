"""The device trace of a traced window, reduced to the numbers the
per-layer metrics read.

``torch.profiler`` records the host's ops and the card's kernels, copies
and sets on one timeline (its kineto events, read without building the
slower ``FunctionEvent`` tree). The window is the ``bench.window`` span.
From it:
the device's busy time (the union of its operations' intervals), the host's
kernel launches, the device time of each operation by name, and each idle
gap of the device named by the host op that ran at its middle (the
outermost op of the host thread that drives the window, or "host: between
ops" when none did). The span's own copy on the device timeline is not an
operation.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


class Tracer:
    """Profiles a window: ``with tracer: ...``; then ``summary()``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._make = lambda: profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
        self.prof = None

    def warm(self, fn) -> None:
        """Profile ``fn()`` once and drop it: the profiler's own start-up
        (seconds on its first use) then stays out of the window."""
        with self._make():
            fn()
            _sync()

    def __enter__(self):
        from torch.profiler import record_function
        self.prof = self._make()
        self.prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        _sync()
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        t0 = time.perf_counter()
        out = reduce(self.prof.profiler.kineto_results.events())
        out["reduce_s"] = time.perf_counter() - t0
        return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _times(e) -> tuple[int, int]:
    """Start and end of a kineto event in ns (older torch: from us)."""
    if hasattr(e, "end_ns"):
        return e.start_ns(), e.end_ns()
    if hasattr(e, "duration_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())


def reduce(events) -> dict:
    """Busy and window seconds, launches, device seconds by operation name
    and idle seconds by host op, from the profiler's kineto events."""
    from torch.autograd import DeviceType
    win = [e for e in events if e.name() == WINDOW_SPAN
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = _times(win[0])
    main = win[0].start_thread_id()
    dev, ops = [], defaultdict(float)
    launches = 0
    host = []
    for e in events:
        name = e.name()
        if name.startswith("bench."):
            continue
        s, t = _times(e)
        if e.device_type() == DeviceType.CUDA:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                ops[name] += (t - s) * 1e-9
        elif name in LAUNCH_NAMES:
            launches += w0 <= s <= w1
        elif e.start_thread_id() == main:
            host.append((s, -t, name))
    busy = _union(dev)
    gaps = []
    edge = w0
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    top, reach = [], None
    for s, neg_t, name in sorted(host):     # the outermost ops, in order
        if reach is None or s >= reach:
            top.append((s, -neg_t, name))
            reach = -neg_t
    starts = [s for s, _, _ in top]
    idle = defaultdict(float)
    for s, t in gaps:
        mid = 0.5 * (s + t)
        j = bisect.bisect_right(starts, mid) - 1
        name = (f"host: {top[j][2]}" if j >= 0 and top[j][1] >= mid
                else "host: between ops")
        idle[name] += (t - s) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(t - s for s, t in busy) * 1e-9,
            "launches": launches, "device_ops": dict(ops),
            "idle_gaps": dict(idle), "n_events": len(events)}


def top_entries(d: dict, n: int = 10, width: int = 120) -> list:
    """The ``n`` largest entries of a name -> seconds map, as [name,
    seconds] pairs, names cut to ``width`` characters."""
    return [[k[:width], v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:n]]
