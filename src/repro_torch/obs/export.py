"""Metrics/trace exposition: Prometheus text, JSON snapshots, HTTP.

Three consumers, one serialization seam (a copy of the JAX package's
module, whose names and formats it keeps):

- a serving process runs :class:`MetricsServer` — a
  stdlib ``http.server`` on a daemon thread serving ``/metrics``
  (Prometheus text exposition), ``/metrics.json`` (the registry
  snapshot plus whatever extra stats callable the owner wires in) and
  ``/traces`` (the tracer's ring as JSON);
- the benchmarks embed :func:`json_snapshot` into their ``BENCH_*.json``
  meta, so recorded runs carry the same histograms an operator would
  scrape;
- tests read both formats back.

Histograms export as Prometheus *summaries* (quantile-labelled gauges
plus ``_sum`` / ``_count``): the registry's quantiles are exact-rank at
bucket resolution, which is what a summary models — re-aggregating
them server-side would be wrong, and that is Prometheus's summary
contract, not ours.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str = "repro_") -> str:
    """Prometheus metric name: prefixed, invalid chars to '_'."""
    return prefix + _NAME_RE.sub("_", name)


def prometheus_text(registry: MetricsRegistry,
                    quantiles=(0.5, 0.9, 0.99)) -> str:
    """The registry in Prometheus text exposition format (v0.0.4)."""
    snap = registry.snapshot()
    lines = []
    for name, value in snap["counters"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} counter", f"{pn} {value}"]
    for name, value in snap["gauges"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} gauge", f"{pn} {value}"]
    for name, summ in snap["histograms"].items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q in quantiles:
            key = f"p{int(q * 100)}"
            if key in summ:
                lines.append(f'{pn}{{quantile="{q}"}} {summ[key]}')
        lines.append(f"{pn}_count {summ['n']}")
        if "mean" in summ:
            lines.append(f"{pn}_sum {summ['mean'] * summ['n']}")
    return "\n".join(lines) + "\n"


def _coerce(obj):
    """``json.dumps`` fallback for numpy and torch values: a numpy scalar,
    a 0-d tensor (on any device) or a tensor element becomes a Python
    number, an array or a tensor a (nested) list. Span attributes carry
    them when callers time or count with numpy or torch."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def json_snapshot(registry: MetricsRegistry, tracer=None,
                  extra: dict | None = None) -> dict:
    """One JSON-able observability snapshot: the metrics registry,
    optionally the tracer's span count + slowest request, plus caller
    extras (scheduler stats, bench config) merged under ``extra``."""
    out = {"metrics": registry.snapshot()}
    if tracer is not None and tracer.enabled:
        out["traces"] = {"spans": len(tracer),
                         "slowest_request": tracer.slowest("request")}
    if extra:
        out["extra"] = extra
    return out


class MetricsServer:
    """``http.server`` exposition on a daemon thread.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    what the tests use). ``extra`` is a zero-arg callable returning a
    JSON-able dict merged into ``/metrics.json`` (the scheduler passes
    its ``stats``), evaluated per request so snapshots are live.
    """

    def __init__(self, registry: MetricsRegistry, tracer=None, *,
                 host: str = "127.0.0.1", port: int = 0, extra=None):
        self.registry = registry
        self.tracer = tracer
        self._extra = extra
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    if self.path == "/metrics":
                        body = prometheus_text(server.registry)
                        ctype = "text/plain; version=0.0.4"
                    elif self.path == "/metrics.json":
                        extra = (server._extra() if callable(server._extra)
                                 else server._extra)
                        body = json.dumps(
                            json_snapshot(server.registry, server.tracer,
                                          extra=extra), default=_coerce)
                        ctype = "application/json"
                    elif self.path == "/traces":
                        spans = (server.tracer.export()
                                 if server.tracer is not None else [])
                        body = json.dumps(spans, default=_coerce)
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # noqa: BLE001 — surface, don't die
                    self.send_error(500, repr(exc))
                    return
                payload = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # quiet: no per-scrape stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-server",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
