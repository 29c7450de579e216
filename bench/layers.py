"""Device time, launches and idle gaps of a traced window by the program's
spans.

The program names its spans under ``rt.`` (``repro_torch.obs.Tracer`` with
``profile=True`` opens a profiler range for each), so its host ranges lie
on the profiler's clock beside the device's operations. The profiler also
copies each range onto the device timeline. ``without_spans`` drops both,
so that ``bench.trace.reduce`` of what is left reads what it reads of a
window without them. ``layers`` credits each device operation to the
innermost span around its launch (the host's CUDA API call, such as
``cudaLaunchKernel``, with the operation's kineto correlation id), each
kernel launch to the innermost span around it, and each idle gap of the
device to the innermost span open at the gap's middle on the thread that
drives the window; what no span holds goes to ``outside``. Each span name
also gets its count and host seconds in the window.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

from .trace import LAUNCH_NAMES, WINDOW_SPAN, _times, _union
from .trace import reduce as reduce_window

PREFIX = "rt."
OUTSIDE = "outside"
RUNTIME = re.compile(r"cu(da)?[A-Z]")   # CUDA API calls: cudaX..., cuX...
FACADE = ("rt.pad", "rt.upload", "rt.plan", "rt.copy")


def without_spans(events) -> list:
    """``events`` without the program's spans, on either timeline."""
    return [e for e in events if not e.name().startswith(PREFIX)]


def reduce(events) -> dict:
    """``bench.trace.reduce`` of the window without the program's spans,
    with ``layers`` added."""
    out = reduce_window(without_spans(events))
    out["layers"] = layers(events)
    out["n_events"] = len(events)
    return out


class _Spans:
    """One thread's spans, properly nested: the innermost one at a time."""

    def __init__(self, spans):
        spans.sort(key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in spans]
        self.ends = [t for _, t, _ in spans]
        self.names = [n for _, _, n in spans]
        self.parent = []
        open_ = []
        for j, (s, _, _) in enumerate(spans):
            while open_ and self.ends[open_[-1]] < s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(j)

    def at(self, t) -> str:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] < t:
            j = self.parent[j]
        return self.names[j] if j >= 0 else OUTSIDE


def layers(events) -> dict:
    """Per span name (and ``outside``): ``device_s``, ``launches``,
    ``idle_s``, ``host_s`` and ``count`` in the ``bench.window`` span."""
    from torch.autograd import DeviceType
    win = [e for e in events if e.name() == WINDOW_SPAN
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = _times(win[0])
    main = win[0].start_thread_id()
    spans, launch_of, ops, launches = defaultdict(list), {}, [], []
    out = defaultdict(lambda: dict.fromkeys(
        ("device_s", "launches", "idle_s", "host_s", "count"), 0))
    out[OUTSIDE]   # reported even when every operation has its span
    for e in events:
        name = e.name()
        s, t = _times(e)
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(("bench.", PREFIX)):
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    ops.append((s, t, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans[e.start_thread_id()].append((s, t, name))
            if w0 <= s <= w1:
                out[name]["count"] += 1
                out[name]["host_s"] += (min(t, w1) - s) * 1e-9
        elif RUNTIME.match(name):
            launch_of[e.correlation_id()] = (e.start_thread_id(), s)
            if name in LAUNCH_NAMES and w0 <= s <= w1:
                launches.append((e.start_thread_id(), s))
    spans = {tid: _Spans(v) for tid, v in spans.items()}

    def owner(tid, t):
        return spans[tid].at(t) if tid in spans else OUTSIDE

    for s, t, corr in ops:
        launch = launch_of.get(corr)
        name = owner(*launch) if launch else OUTSIDE
        out[name]["device_s"] += (t - s) * 1e-9
    for tid, s in launches:
        out[owner(tid, s)]["launches"] += 1
    edge = w0
    for s, t in _union([(s, t) for s, t, _ in ops]) + [[w1, w1]]:
        if s > edge:      # an idle gap, named at its middle
            name = owner(main, 0.5 * (edge + s))
            out[name]["idle_s"] += (s - edge) * 1e-9
        edge = max(edge, t)
    return dict(out)


def per_unit(run, key: str, names, unit: str = "steps") -> float | None:
    """Milliseconds of ``key`` in the spans ``names`` of the traced window
    over its chunk steps (``unit="steps"``: the largest
    ``chunks_dispatched`` of each search, summed) or its searches
    (``"searches"``); None without a layer breakdown."""
    lay = (run.trace or {}).get("layers")
    n = (sum(s["steps"] for s in run.searches) if unit == "steps"
         else len(run.searches))
    if lay is None or n == 0:
        return None
    return 1e3 * sum(lay[name][key] for name in names if name in lay) / n
