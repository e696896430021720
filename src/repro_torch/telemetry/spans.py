"""Per-request trace spans (DESIGN.md §12).

A span is a plain JSON-able list ``[name, host, t0, t1]`` with
``time.perf_counter()`` timestamps (monotonic *per host*; hosts are not
clock-synchronized, which is why the Chrome-trace export maps each host
to its own ``pid`` instead of fabricating a global timeline).

Span vocabulary along the request path:

    admit        submit() entry -> request prepared/admitted
    route        cluster frontend routing decision (cluster only)
    retry        failure detected -> re-admission on a surviving host
                 (failover/hedge only; precedes a fresh route span)
    batch_wait   admitted -> the request's bucket batch dispatched
    operands     operand build / device upload (cache hit makes it short)
    compute      dispatch -> device results materialized
    wire_measure rANS coding + wire-model accounting (measure_wire only)
    complete     result finalization (slice-out, drift, wire fields)

Spans ride on ``SolveRequest.spans`` / ``SolveResult.spans`` and cross
host boundaries inside codec JSON headers (floats round-trip exactly
through Python's ``json``).
"""
from __future__ import annotations

import json
import time
from typing import IO, Iterable, List, Optional, Sequence

__all__ = [
    "now", "span", "span_names", "spans_monotonic", "missing_spans",
    "expected_spans", "tag_host", "chrome_trace_events", "write_trace_jsonl",
]

Span = List  # [name: str, host: str | None, t0: float, t1: float]

CORE_SPANS = ("admit", "batch_wait", "operands", "compute", "complete")


def now() -> float:
    return time.perf_counter()


def span(name: str, t0: float, t1: Optional[float] = None,
         host: Optional[str] = None) -> Span:
    return [name, host, float(t0), float(t1 if t1 is not None else now())]


def span_names(spans: Optional[Sequence[Span]]) -> List[str]:
    return [s[0] for s in (spans or [])]


def tag_host(spans: Optional[Sequence[Span]], host: str) -> List[Span]:
    """Fill in the host field on spans that don't have one yet (the
    backend emits host=None; the frontend knows which host it routed to)."""
    return [[s[0], s[1] if s[1] is not None else host, s[2], s[3]]
            for s in (spans or [])]


def expected_spans(*, wire: bool = False, cluster: bool = False) -> List[str]:
    names = list(CORE_SPANS)
    if wire:
        names.insert(names.index("complete"), "wire_measure")
    if cluster:
        names.insert(1, "route")
    return names


def missing_spans(spans: Optional[Sequence[Span]], *, wire: bool = False,
                  cluster: bool = False) -> List[str]:
    """Names from the expected vocabulary absent from ``spans`` — an
    incomplete span tree means some plane dropped instrumentation."""
    have = set(span_names(spans))
    return [n for n in expected_spans(wire=wire, cluster=cluster)
            if n not in have]


def spans_monotonic(spans: Optional[Sequence[Span]]) -> bool:
    """Every span well-formed (t1 >= t0) and, per host, span start times
    non-decreasing in list order (the order the planes appended them)."""
    last_t0: dict = {}
    for s in (spans or []):
        name, host, t0, t1 = s[0], s[1], float(s[2]), float(s[3])
        if t1 < t0:
            return False
        if t0 < last_t0.get(host, -float("inf")):
            return False
        last_t0[host] = t0
    return True


def chrome_trace_events(request_id: int, spans: Sequence[Span]) -> List[dict]:
    """Chrome trace-event ``"X"`` (complete) events for one request.

    pid = host (hosts have independent clocks — keeping them in separate
    pid lanes is honest about skew), tid = request id, ts/dur in us.
    """
    out = []
    for s in (spans or []):
        name, host, t0, t1 = s[0], s[1], float(s[2]), float(s[3])
        out.append({
            "name": name, "ph": "X", "pid": str(host or "local"),
            "tid": int(request_id), "ts": t0 * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6, "cat": "amp",
        })
    return out


def write_trace_jsonl(fp: IO[str], results: Iterable) -> int:
    """Append one Chrome trace event per line for each result carrying
    spans. Returns the number of events written. The file is valid JSONL;
    ``[`` + join(lines, ",") + ``]`` is a loadable Chrome trace."""
    n = 0
    for r in results:
        spans = getattr(r, "spans", None)
        if not spans:
            continue
        rid = getattr(r, "request_id", -1)
        for ev in chrome_trace_events(rid, spans):
            fp.write(json.dumps(ev, separators=(",", ":")) + "\n")
            n += 1
    return n
