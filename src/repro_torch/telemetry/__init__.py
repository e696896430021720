"""Unified telemetry plane: metrics registry, request trace spans, and
live SE-drift monitoring (the JAX package's ``repro.telemetry``, kept as it
is, with the drift monitor on this package's state evolution; its
DESIGN.md §12).

Dependency-free by design — snapshots and spans are plain JSON-able
structures that ride the serving plane's no-pickle codec across host
boundaries and render as Prometheus text or Chrome trace-event JSONL.
"""
from .drift import DRIFT_ALERT, se_drift, se_drift_batch, se_prediction
from .metrics import (DRIFT_BUCKETS, LATENCY_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, hist_quantile,
                      merge_snapshots, prometheus_text)
from .spans import (chrome_trace_events, expected_spans, missing_spans,
                    now, span, span_names, spans_monotonic, tag_host,
                    write_trace_jsonl)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "prometheus_text", "merge_snapshots", "hist_quantile",
    "LATENCY_BUCKETS", "DRIFT_BUCKETS",
    "now", "span", "span_names", "spans_monotonic", "missing_spans",
    "expected_spans", "tag_host", "chrome_trace_events",
    "write_trace_jsonl",
    "se_drift", "se_drift_batch", "se_prediction", "DRIFT_ALERT",
]
