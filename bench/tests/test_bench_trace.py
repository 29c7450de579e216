"""The program's spans in a traced window (``bench.layers``), on kineto-like
events made by hand: the window's reduction without them, the device time,
launches and idle gaps credited to them, and the readers of the per-layer
metrics that read them."""
import importlib
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench import layers
from bench.trace import reduce

MAIN, OTHER = 1, 2
READERS = ("gather_device_ms", "counts_device_ms", "merge_device_ms",
           "chunk_idle_ms", "facade_ms")


class Event:
    """The part of a kineto event that the reductions read."""

    def __init__(self, name, start, end, *, device=False, tid=MAIN,
                 corr=0):
        self._name, self._s, self._e = name, start, end
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._tid, self._corr = tid, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr


def _launch(name, at, corr, dur, *, tid=MAIN, start=None):
    """An ``aten`` op on the host that launches kernel ``corr``, which runs
    on the device from ``start`` (the launch's end by default)."""
    start = at + 2 if start is None else start
    return [Event(f"aten::{name}", at, at + 3, tid=tid),
            Event("cudaLaunchKernel", at + 1, at + 2, tid=tid, corr=corr),
            Event(f"{name}_kernel", start, start + dur, device=True,
                  corr=corr)]


def _window():
    """A window of one search: a copy before the chunk loop, then one chunk
    whose gather and counts each launch a kernel, then the loop's test,
    whose sync leaves the device idle; one kernel outside every span."""
    return ([Event("bench.window", 0, 1000),
             Event("bench.window", 0, 1000, device=True)]
            + _launch("copy_", 10, 1, 40)        # device 12..52
            + _launch("index", 100, 2, 200)      # device 102..302
            + _launch("scatter_add_", 110, 3, 300, start=302)  # 302..602
            + _launch("gt", 700, 4, 10)          # device 702..712
            + _launch("add", 950, 5, 20, tid=OTHER))   # 952..972


def _spans():
    """The program's ranges over ``_window``, on both timelines."""
    host = [("rt.search", 7, 900), ("rt.upload", 8, 60),
            ("rt.chunk", 95, 650), ("rt.chunk.gather", 98, 105),
            ("rt.chunk.counts", 108, 115), ("rt.chunk.test", 690, 890)]
    return ([Event(n, s, e) for n, s, e in host]
            + [Event(n, s + 2, e, device=True) for n, s, e in host])


def test_reduce_reads_the_same_without_the_programs_spans():
    """``without_spans`` takes the program's ranges off both timelines, so
    the window's existing numbers read as without them; unfiltered, their
    device copies would count as busy time."""
    base = reduce(_window())
    with_spans = _window() + _spans()
    got = reduce(layers.without_spans(with_spans))
    assert {k: v for k, v in got.items() if k != "n_events"} == \
        {k: v for k, v in base.items() if k != "n_events"}
    full = layers.reduce(with_spans)
    assert {k: full[k] for k in base if k != "n_events"} == \
        {k: base[k] for k in base if k != "n_events"}
    assert full["n_events"] == len(with_spans)
    raw = reduce(with_spans)
    assert raw["busy_s"] > base["busy_s"]


def test_a_kernel_is_credited_to_the_span_around_its_launch():
    """The device time of a kernel goes to the innermost span around the
    host's launch with its correlation id, wherever on the device it runs;
    a kernel launched outside every span goes to ``outside``."""
    lay = layers.layers(_window() + _spans())
    assert lay["rt.chunk.counts"]["device_s"] == pytest.approx(300e-9)
    assert lay["rt.chunk.gather"]["device_s"] == pytest.approx(200e-9)
    assert lay["rt.upload"]["device_s"] == pytest.approx(40e-9)
    assert lay["rt.chunk.test"]["device_s"] == pytest.approx(10e-9)
    assert lay["outside"]["device_s"] == pytest.approx(20e-9)
    assert lay["rt.chunk"]["device_s"] == 0
    for name in ("rt.upload", "rt.chunk.gather", "rt.chunk.counts",
                 "rt.chunk.test", "outside"):
        assert lay[name]["launches"] == 1, name
    assert sum(v["launches"] for v in lay.values()) == 5
    assert lay["rt.chunk"]["count"] == 1
    assert lay["rt.chunk"]["host_s"] == pytest.approx(555e-9)


def test_an_idle_gap_is_credited_to_the_span_open_at_its_middle():
    """Gaps: 0..12 (middle 6: no span), 52..102 (77: ``rt.search``, the
    upload has ended), 602..702 (652: ``rt.search``), 712..952 (832:
    ``rt.chunk.test``), 972..1000 (986: no span)."""
    lay = layers.layers(_window() + _spans())
    idle = {k: v["idle_s"] for k, v in lay.items() if v["idle_s"]}
    assert idle == pytest.approx({"outside": 40e-9, "rt.search": 150e-9,
                                  "rt.chunk.test": 240e-9})
    base = reduce(_window())
    assert sum(idle.values()) == pytest.approx(
        base["window_s"] - base["busy_s"])


def _run(trace, steps=(2.0, 3.0)):
    return SimpleNamespace(trace=trace,
                           searches=[{"steps": s} for s in steps])


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_layers(name):
    reader = importlib.import_module(f"bench.metrics.{name}")
    assert reader.read(_run(None)) is None
    assert reader.read(_run(reduce(_window()))) is None
    assert reader.read(_run(layers.reduce(_window() + _spans()), ())) \
        is None


@pytest.mark.parametrize("name,want", [
    ("gather_device_ms", 200e-6 / 5), ("counts_device_ms", 300e-6 / 5),
    ("merge_device_ms", 0.0), ("chunk_idle_ms", 240e-6 / 5),
    ("facade_ms", 52e-6 / 2)])
def test_readers_read_the_layers(name, want):
    """Per chunk step (5 in all) or per search (2): the window holds one
    upload (52 ns of host time) and no pad, plan or copy."""
    reader = importlib.import_module(f"bench.metrics.{name}")
    got = reader.read(_run(layers.reduce(_window() + _spans())))
    assert got == pytest.approx(want)
