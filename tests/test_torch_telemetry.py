"""The port's telemetry plane (``repro_torch.telemetry``), its rANS coder
and measured wire bytes against the JAX package's, on the CPU; and the
telemetry of the port's solve service (spans, drift, metrics surface).

The metrics registry, spans and the coder are the same pure Python on both
sides, so their outputs are held equal. The drift monitor runs on each
package's own state evolution (float64 numpy on both sides): its numbers
are held to 1e-9 relative.
"""
import io
import json
import math

import numpy as np
import pytest

import repro.core.denoisers as jd
import repro.core.entropy_code as jec
import repro.core.state_evolution as jse
import repro.serving.wire as jwire
import repro.telemetry as jtel
import repro.telemetry.spans as jspans
import repro_torch.core.denoisers as td
import repro_torch.core.entropy_code as tec
import repro_torch.core.state_evolution as tse
import repro_torch.serving.wire as twire
import repro_torch.telemetry as ttel
import repro_torch.telemetry.spans as tspans
from repro_torch.serving import BucketPolicy, SolveRequest, SolveService

POL = BucketPolicy(max_batch=8, n_quantum=64, mp_quantum=8)


def make_reqs(n_req, n=128, m=64, p=4, t=8, seed=0, policy="fixed", **kw):
    """Fixed-schedule requests drawn with numpy (the port's own requests)."""
    prior = td.BernoulliGauss(eps=0.1)
    prob = tse.CSProblem(n=n, m=m, prior=prior, snr_db=20.0)
    deltas = None
    if policy == "fixed":
        deltas = np.full(t, 0.05, np.float32)
        deltas[0] = np.inf
    reqs = []
    for i in range(n_req):
        rng = np.random.default_rng(seed + i)
        s0 = ((rng.random(n) < 0.1) * rng.normal(size=n)).astype(np.float32)
        a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
        y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)
             ).astype(np.float32)
        reqs.append(SolveRequest(y=y, a=a, prior=prior, n_proc=p, n_iter=t,
                                 policy=policy, deltas=deltas, **kw))
    return prior, reqs


def _fill(tel):
    """The same metric operations on one package's registry."""
    reg = tel.MetricsRegistry()
    reg.counter("amp_x_total", "help text", ("k",)).inc(3, k='a"b\\c')
    c = reg.counter("amp_c_total", labelnames=("layout",))
    c.inc(2, layout="row")
    c.labels(layout="col").inc()
    reg.gauge("amp_g", "a gauge").set(4.5)
    h = reg.histogram("amp_h", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    h.observe_many([0.2, 0.02])
    reg.collect(lambda r: r.counter("amp_pulled_total").set_total(7))
    return reg.snapshot()


def test_metrics_snapshot_and_text_equal_the_reference():
    want, got = _fill(jtel), _fill(ttel)
    assert got == want
    assert ttel.prometheus_text(got) == jtel.prometheus_text(want)
    (hw,) = [m for m in want["metrics"] if m["name"] == "amp_h"]
    (hg,) = [m for m in got["metrics"] if m["name"] == "amp_h"]
    for q in (0.1, 0.5, 0.95):
        assert ttel.hist_quantile(hg["samples"][0], q) == \
            jtel.hist_quantile(hw["samples"][0], q)
    merged_w = jtel.merge_snapshots([("h0", want), ("h1", want)])
    merged_g = ttel.merge_snapshots([("h0", got), ("h1", got)])
    assert merged_g == merged_w
    assert ttel.LATENCY_BUCKETS == jtel.LATENCY_BUCKETS
    assert ttel.DRIFT_BUCKETS == jtel.DRIFT_BUCKETS


def test_spans_helpers_equal_the_reference():
    spans = [tspans.span(n, i, i + 0.5) for i, n in
             enumerate(tspans.expected_spans())]
    assert spans == [jspans.span(n, i, i + 0.5) for i, n in
                     enumerate(jspans.expected_spans())]
    for kw in ({}, {"wire": True}, {"cluster": True}):
        assert tspans.expected_spans(**kw) == jspans.expected_spans(**kw)
        assert tspans.missing_spans(spans, **kw) == \
            jspans.missing_spans(spans, **kw)
    assert tspans.spans_monotonic(spans) and \
        not tspans.spans_monotonic([tspans.span("a", 1.0, 0.5)])
    tagged = [["a", None, 0.0, 1.0], ["b", "h", 1.0, 2.0]]
    assert tspans.tag_host([list(s) for s in tagged], "z") == \
        jspans.tag_host([list(s) for s in tagged], "z")
    hosted = [tspans.span("admit", 1.0, 1.5, host="frontend"),
              tspans.span("compute", 2.0, 2.25)]
    assert tspans.chrome_trace_events(7, hosted) == \
        jspans.chrome_trace_events(7, hosted)
    import types
    rows = [types.SimpleNamespace(request_id=7, spans=hosted),
            types.SimpleNamespace(request_id=8, spans=None)]
    fw, fg = io.StringIO(), io.StringIO()
    assert tspans.write_trace_jsonl(fg, rows) == \
        jspans.write_trace_jsonl(fw, rows) == 2
    assert fg.getvalue() == fw.getvalue()
    assert [json.loads(l)["name"] for l in fg.getvalue().splitlines()] == \
        ["admit", "compute"]


@pytest.mark.parametrize("layout", ["row", "col"])
def test_drift_equals_the_reference(layout):
    """se_drift / se_drift_batch / se_prediction on the same trace, each on
    its own package's state evolution."""
    n, m, p, t = 512, 160, 5, 6
    jprob = jse.CSProblem(n=n, m=m, prior=jd.BernoulliGauss(0.1), snr_db=20.0)
    tprob = tse.CSProblem(n=n, m=m, prior=td.BernoulliGauss(0.1), snr_db=20.0)
    ev = np.full(t, 1e-3)
    ev[0] = 0.0
    pw = jtel.se_prediction(jprob, t, ev, layout=layout, n_proc=p)
    pg = ttel.se_prediction(tprob, t, ev, layout=layout, n_proc=p)
    np.testing.assert_allclose(pg, pw, rtol=1e-9)
    rng = np.random.default_rng(3)
    s2 = pw[None, :] * np.exp(0.2 * rng.normal(size=(4, t)))
    s2[2, 1] = 0.0                   # an iteration without a ratio
    for i in range(4):
        dw, _ = jtel.se_drift(jprob, s2[i], ev, layout=layout, n_proc=p)
        dg, _ = ttel.se_drift(tprob, s2[i], ev, layout=layout, n_proc=p)
        np.testing.assert_allclose(dg, dw, rtol=1e-9)
    np.testing.assert_allclose(
        ttel.se_drift_batch(tprob, s2, ev, layout=layout, n_proc=p),
        jtel.se_drift_batch(jprob, s2, ev, layout=layout, n_proc=p),
        rtol=1e-9)
    evs = np.stack([ev, 2 * ev, ev, 3 * ev])
    np.testing.assert_allclose(
        ttel.se_drift_batch(tprob, s2, evs, layout=layout, n_proc=p),
        jtel.se_drift_batch(jprob, s2, evs, layout=layout, n_proc=p),
        rtol=1e-9)
    d_nan, _ = ttel.se_drift(tprob, np.zeros(t), ev, layout=layout,
                             n_proc=p)
    assert math.isnan(d_nan)
    assert ttel.DRIFT_ALERT == jtel.DRIFT_ALERT


def test_rans_bytes_equal_the_reference():
    """The same symbol streams code to the same bytes, and measured wire
    accounting (coded and lossless rounds) is the reference's number for
    number."""
    rng = np.random.default_rng(0)
    syms = np.round(rng.normal(scale=3.0, size=(5, 4, 300))).astype(np.int64)
    for stream in (syms[1, 0], syms[2, 3], np.zeros(50, np.int64)):
        shifted = stream - stream.min()
        counts = np.bincount(shifted)
        bw = jec.RansCodec(counts).encode(shifted)
        bg = tec.RansCodec(counts).encode(shifted)
        assert bytes(bg) == bytes(bw)
        np.testing.assert_array_equal(
            tec.RansCodec(counts).decode(bg, len(shifted)), shifted)
    deltas = np.asarray([np.inf, 0.1, 0.05, 0.05, 0.02])
    want = jwire.measure_wire(syms.astype(np.float32), deltas, 280)
    got = twire.measure_wire(syms.astype(np.float32), deltas, 280)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    drop = (rng.random((5, 4)) < 0.2).astype(np.float32)
    model = twire.WireModel(bitrate_bps=2e6, overhead_bytes=4.0)
    got = twire.measure_wire(syms, deltas, 300, drop=drop, model=model)
    want = jwire.measure_wire(syms, deltas, 300, drop=drop,
                              model=jwire.WireModel(bitrate_bps=2e6,
                                                    overhead_bytes=4.0))
    assert got["bytes_on_wire"] == want["bytes_on_wire"]


# ---------------------------------------------------------------------------
# the service's telemetry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def telem_svc():
    svc = SolveService(policy=POL, rate_accounting=False, device="cpu")
    _, reqs = make_reqs(8)
    return svc, svc.solve(reqs)


def test_batched_path_span_tree(telem_svc):
    svc, results = telem_svc
    for r in results:
        assert r.batch_size == 8
        assert tspans.missing_spans(r.spans) == []
        assert tspans.span_names(r.spans) == tspans.expected_spans()
        assert tspans.spans_monotonic(r.spans), r.spans
        assert {s[1] for s in r.spans} == {None}
    ops = {tuple(s) for r in results for s in r.spans if s[0] == "operands"}
    assert len(ops) == 1


def test_batched_path_drift_clean(telem_svc):
    """Clean solves have a well-defined drift, typically well under the
    alert line (the reference test's bound)."""
    _, results = telem_svc
    drifts = [r.se_drift for r in results]
    assert all(d is not None and math.isfinite(d) for d in drifts), drifts
    assert float(np.median(drifts)) < 0.75, drifts


def test_service_metrics_surface(telem_svc):
    svc, results = telem_svc
    by_name = {m["name"]: m for m in svc.metrics()["metrics"]}
    assert sum(s["value"] for s in
               by_name["amp_requests_total"]["samples"]) >= len(results)
    (lat,) = [s for s in by_name["amp_request_latency_seconds"]["samples"]
              if s["labels"]["layout"] == "row"]
    assert lat["count"] >= len(results)
    assert sum(lat["counts"]) == lat["count"]
    (dr,) = by_name["amp_se_drift"]["samples"]
    assert dr["count"] >= len(results)
    comp = sum(s["value"]
               for s in by_name["amp_engine_compiles_total"]["samples"])
    assert comp == svc.compile_count() > 0
    assert "amp_operand_cache_hits_total" in by_name
    text = svc.metrics_text()
    assert "# TYPE amp_request_latency_seconds histogram" in text
    assert "amp_se_drift_bucket" in text


def test_singleton_fast_path_span_tree():
    svc = SolveService(policy=POL, rate_accounting=False, device="cpu")
    _, (req,) = make_reqs(1, seed=30, policy="lossless")
    svc.submit(req)
    (res,) = svc.flush()
    assert res.batch_size == 1
    assert svc.stats()["singleton_dispatches"] == 1
    assert tspans.missing_spans(res.spans) == []
    assert tspans.spans_monotonic(res.spans), res.spans
    # the drift of its own trace (at N=128 a single realization's drift
    # is no test of the monitor: the reference's docstring says so)
    want, _ = ttel.se_drift(req.problem(), res.sigma2_hat, res.extra_var,
                            n_proc=req.n_proc)
    assert res.se_drift == want and math.isfinite(want)


def test_measure_wire_span_tree_and_bytes():
    """The symbol-tracing engine twin adds the wire_measure span; its
    bytes are the reference coder's on the port's symbols."""
    svc = SolveService(policy=POL, rate_accounting=False, device="cpu")
    _, reqs = make_reqs(2, seed=40, measure_wire=True)
    results = svc.solve(reqs)
    for r in results:
        assert r.bytes_on_wire is not None and r.bytes_on_wire > 0
        assert r.payload_bytes < r.bytes_on_wire
        assert tspans.missing_spans(r.spans, wire=True) == []
        assert tspans.span_names(r.spans) == \
            tspans.expected_spans(wire=True)
        assert tspans.spans_monotonic(r.spans), r.spans
    # the twin engine traced the symbols; the plain engines did not
    (eng,) = svc._wire_engines.values()
    assert eng.cfg.collect_symbols and not svc._engines


def test_telemetry_off_is_clean():
    svc = SolveService(policy=POL, rate_accounting=False, telemetry=False,
                       device="cpu")
    _, reqs = make_reqs(2, seed=60)
    for r in svc.solve(reqs):
        assert r.spans is None and r.se_drift is None
    assert svc.metrics() == {"metrics": []}
    assert svc.metrics_text() == ""
