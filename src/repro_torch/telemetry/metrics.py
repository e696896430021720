"""Thread-safe metrics registry (DESIGN.md §12).

Dependency-free observability primitives for the serving plane: counters,
gauges, and fixed-bucket histograms keyed by label tuples, with atomic
snapshots rendered as JSON-able dicts or Prometheus text exposition
format.

Design notes (why this is not prometheus_client):

- No background server, no pip dependency; snapshots are plain JSON-able
  dicts, which a cluster frontend merges with a ``host`` label.
- Hot-path cost is one dict lookup + float add under a per-registry
  lock.  Expensive sources (engine counters, cache stats, router state)
  are *pulled* by collector callbacks at snapshot time, not pushed per
  request, which is what keeps enabled-telemetry overhead inside the 2%
  budget (``BENCH_serve.json`` ``telemetry_overhead``).
- Naming scheme: ``amp_<plane>_<what>_<unit>`` — e.g.
  ``amp_engine_compiles_total``, ``amp_request_latency_seconds``,
  ``amp_se_drift``.  Suffixes follow Prometheus conventions
  (``_total`` for counters, ``_seconds``/``_bytes`` for units).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "prometheus_text", "merge_snapshots", "hist_quantile",
    "LATENCY_BUCKETS", "DRIFT_BUCKETS", "RECOVERY_BUCKETS", "HOST_STATES",
]

# Request latencies span ~100us (cached singleton) to seconds (cold batch).
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# SE drift is mean |log(realized/predicted)|: clean solves sit well below
# 0.5; a mis-rated solve (wrong SNR / stale RD table) lands above 1.
DRIFT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0,
)
# Failover recovery (failure detected -> re-admitted request completed,
# DESIGN.md §13): dominated by the surviving host's batch+compute time,
# so the grid extends past LATENCY_BUCKETS into the tens of seconds a
# cold re-dispatch under load can take.
RECOVERY_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# amp_host_state gauge encoding (the router's host state machine)
HOST_STATES: Tuple[str, ...] = ("healthy", "suspect", "dead", "draining")

_LabelKey = Tuple[str, ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> _LabelKey:
    # hot path: build the key straight from the declared order, catching
    # missing names via KeyError — two set() builds per observe would
    # double the cost of every counter bump
    try:
        key = tuple(str(labels[k]) for k in labelnames)
    except KeyError:
        key = None
    if key is None or len(labels) != len(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return key


class _Child:
    """Label-bound handle (prometheus_client's ``.labels()`` idiom): hot
    paths resolve the label key once and keep the child, turning every
    subsequent bump into a lock + dict update with no per-call label
    validation (the <=2% telemetry-overhead budget, DESIGN.md §12)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: _LabelKey):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        m = self._metric
        with m._lock:
            m._series[self._key] = m._series.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        m = self._metric
        with m._lock:
            m._series[self._key] = float(value)

    def observe(self, value: float) -> None:
        self._metric._observe_key(self._key, (value,))

    def observe_many(self, values: Iterable[float]) -> None:
        self._metric._observe_key(self._key, values)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[_LabelKey, object] = {}

    def labels(self, **labels: str) -> _Child:
        return _Child(self, _label_key(self.labelnames, labels))


class Counter(_Metric):
    """Monotone float counter, one series per label-value tuple."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, value: float, **labels: str) -> None:
        """Pull-time absolute assignment — for collector callbacks that
        mirror an external monotone counter (engine compiles, cache hits)
        instead of double-counting events."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def _snapshot(self) -> List[dict]:
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    _snapshot = Counter._snapshot


class Histogram(_Metric):
    """Fixed-bound cumulative-bucket histogram (Prometheus semantics).

    Each series stores per-bucket counts (le = upper bound, +Inf
    implicit), plus sum and count; quantiles are estimated from the
    bucket upper bounds (``hist_quantile``) — conservative, never
    under-reports.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or b != tuple(dict.fromkeys(b)):
            raise ValueError(f"bad histogram buckets {buckets}")
        self.buckets = b

    def observe(self, value: float, **labels: str) -> None:
        self.observe_many((value,), **labels)

    def observe_many(self, values: Iterable[float], **labels: str) -> None:
        """Bulk observation under one lock acquisition / label-key build —
        the batched dispatch path records a whole bucket group's
        latencies and drifts in one call (the <=2% telemetry-overhead
        budget, DESIGN.md §12)."""
        self._observe_key(_label_key(self.labelnames, labels), values)

    def _observe_key(self, key: _LabelKey, values: Iterable[float]) -> None:
        bounds = self.buckets
        overflow = len(bounds)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "counts": [0] * (overflow + 1),
                    "sum": 0.0, "count": 0,
                }
            counts = s["counts"]
            tot, n = 0.0, 0
            for v in values:
                # bisect_left == first bound >= v, i.e. the `value <= le`
                # Prometheus bucket; NaN compares false everywhere ->
                # route it to +Inf explicitly
                counts[overflow if v != v else bisect_left(bounds, v)] += 1
                tot += v
                n += 1
            # one float() per flush (not per value) keeps sums JSON-able
            # even when callers hand in numpy scalars
            s["sum"] += float(tot)
            s["count"] += n

    def _snapshot(self) -> List[dict]:
        out = []
        for k, s in sorted(self._series.items()):
            out.append({"labels": dict(zip(self.labelnames, k)),
                        "bounds": list(self.buckets),
                        "counts": list(s["counts"]),
                        "sum": s["sum"], "count": s["count"]})
        return out


def hist_quantile(sample: dict, q: float) -> Optional[float]:
    """Quantile estimate from one histogram snapshot sample.

    Returns the upper bound of the bucket containing the q-quantile
    (+Inf bucket reports the largest finite bound — an underestimate
    flagged by the caller if it matters). None when the series is empty.
    """
    count = sample.get("count", 0)
    if count <= 0:
        return None
    rank = q * count
    seen = 0
    for bound, c in zip(sample["bounds"], sample["counts"]):
        seen += c
        if seen >= rank:
            return float(bound)
    return float(sample["bounds"][-1])


class MetricsRegistry:
    """Registry of named metrics plus pull-time collector callbacks.

    ``collect(fn)`` registers a callback run inside ``snapshot()`` —
    used by the service to fold in sources that already keep their own
    atomic counters (engine, operand cache, batcher, router) without
    adding hot-path writes.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _get(self, cls, name: str, help: str, labelnames: Sequence[str],
             **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              self._lock, **kw)
            elif type(m) is not cls or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} "
                    f"labels={tuple(labelnames)} (was {m.kind} {m.labelnames})")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def collect(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> dict:
        """Atomic JSON-able snapshot: runs collectors, then copies every
        series under the registry lock."""
        for fn in list(self._collectors):
            fn(self)
        with self._lock:
            return {"metrics": [
                {"name": m.name, "kind": m.kind, "help": m.help,
                 "labelnames": list(m.labelnames), "samples": m._snapshot()}
                for m in sorted(self._metrics.values(), key=lambda m: m.name)
            ]}


def merge_snapshots(snaps: Sequence[Tuple[str, dict]]) -> dict:
    """Merge per-host snapshots into one, adding a ``host`` label to every
    sample (Prometheus-style per-host series; no cross-host summing, so
    nothing is lost and histograms stay exact)."""
    merged: Dict[str, dict] = {}
    for host, snap in snaps:
        for m in snap.get("metrics", []):
            name = m["name"]
            dst = merged.get(name)
            if dst is None:
                dst = merged[name] = {
                    "name": name, "kind": m["kind"], "help": m.get("help", ""),
                    "labelnames": ["host"] + list(m.get("labelnames", [])),
                    "samples": [],
                }
            for s in m.get("samples", []):
                s2 = dict(s)
                s2["labels"] = {"host": str(host), **s.get("labels", {})}
                dst["samples"].append(s2)
    return {"metrics": [merged[k] for k in sorted(merged)]}


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    esc = lambda v: str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items())) + "}"


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(snapshot: dict) -> str:
    """Render a snapshot (or ``merge_snapshots`` output) as Prometheus
    text exposition format v0.0.4."""
    lines: List[str] = []
    for m in snapshot.get("metrics", []):
        name, kind = m["name"], m.get("kind", "untyped")
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for s in m.get("samples", []):
            labels = s.get("labels", {})
            if kind == "histogram":
                cum = 0
                for bound, c in zip(s["bounds"], s["counts"]):
                    cum += c
                    lab = _fmt_labels({**labels, "le": _fmt_num(bound)})
                    lines.append(f"{name}_bucket{lab} {cum}")
                cum += s["counts"][len(s["bounds"])]
                lab = _fmt_labels({**labels, "le": "+Inf"})
                lines.append(f"{name}_bucket{lab} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_num(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_num(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")
