"""``repro_torch.obs``: tracing, metrics, export, and the serving cost
model, copies of the JAX package's ``repro.obs``.

:mod:`~repro_torch.obs.spans` (per-request tracing with a bounded ring and
a zero-cost disabled path), :mod:`~repro_torch.obs.metrics` (counters,
gauges, mergeable log-bucketed histograms with exact-rank quantiles),
:mod:`~repro_torch.obs.export` (Prometheus text, JSON snapshots and an
HTTP server) and :mod:`~repro_torch.obs.cost` (the trace-fitted
chunk-count predictor). They need only numpy and the standard library.

``obs.trace_exec``, which adapts ``core.traversal`` stats into span
attributes, imports torch through the traversal, so its consumers import
it explicitly.
"""
from .cost import FEATURES, CostModel, QueryFeaturizer  # noqa: F401
from .export import (MetricsServer, json_snapshot,  # noqa: F401
                     prometheus_text)
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, aggregate_latencies, exact_quantile)
from .spans import (NULL_SPAN, NULL_TRACER, NullTracer,  # noqa: F401
                    Span, Tracer)
