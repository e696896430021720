"""The port's cluster plane on the CPU: the codec against the reference's
byte for byte (both directions, requests with their erasure fields and
results), the router and autoscaler against the reference's on the same
scripted sequences, a ``ClusterService`` of in-process hosts against one
``SolveService`` bit for bit, the TCP backend on a loopback socket, and the
multi-process launcher.

Every socket has a timeout, every thread and child process is joined with
a deadline: no test waits without a bound.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.denoisers as jd
import repro.serving as jsv
import repro.serving.buckets as jbk
import repro.serving.codec as jcodec
import repro_torch.core.denoisers as td
import repro_torch.serving as tsv
import repro_torch.serving.codec as tcodec
from repro_torch.serving.frontend import BackendServer, LocalBackend, TcpBackend

from test_torch_engine import make_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POL = tsv.BucketPolicy(max_batch=8, n_quantum=64, mp_quantum=8)
JOIN_S = 10.0


def make_reqs(n_req, n=128, m=64, p=4, t=8, seed=0, erasure_every=0):
    """Fixed-schedule row requests drawn with numpy; every
    ``erasure_every``-th one (if > 0) on a lossy link."""
    prior = td.BernoulliGauss(eps=0.1)
    deltas = np.full(t, 0.05, np.float32)
    deltas[0] = np.inf
    reqs = []
    for i in range(n_req):
        _, a, y = make_problem(seed + i, n, m, 0.1)
        er = {}
        if erasure_every and i % erasure_every == 0:
            er = dict(erasure_rate=0.2, erasure_model="gilbert",
                      erasure_seed=i)
        reqs.append(tsv.SolveRequest(y=y, a=a, prior=prior, n_proc=p,
                                     n_iter=t, policy="fixed", deltas=deltas,
                                     **er))
    return prior, reqs


def _service(**kw):
    return tsv.SolveService(policy=POL, rate_accounting=False, device="cpu",
                            **kw)


# ---------------------------------------------------------------------------
# codec: the reference's frame format, byte for byte, both directions
# ---------------------------------------------------------------------------

def _request_fields(erasure: bool, deltas: bool):
    rng = np.random.default_rng(3)
    kw = dict(y=rng.standard_normal(16).astype(np.float32),
              a=rng.standard_normal((16, 32)).astype(np.float32),
              snr_db=17.5, n_proc=4, n_iter=5, policy="fixed" if deltas
              else "lossless", bt_c_ratio=1.01, transport="ecsq",
              layout="row", measure_wire=True, a_id="A7", request_id=11,
              spans=[["admit", "frontend", 1.0, 2.0]])
    if deltas:
        kw["deltas"] = np.array([np.inf, 0.1, 0.05, 0.05, 0.02], np.float32)
    if erasure:
        kw.update(erasure_rate=0.15, erasure_model="gilbert",
                  erasure_burst=3.0, erasure_seed=99, recovery="rate_up")
    return kw


def _result_fields():
    rng = np.random.default_rng(4)
    return dict(request_id=3, x=rng.standard_normal(32).astype(np.float32),
                sigma2_hat=np.array([1.0, 0.5, np.nan], np.float32),
                deltas=np.array([np.inf, 0.1, 0.1], np.float32),
                extra_var=np.array([0.0, 1e-3, 1e-3], np.float32),
                rates=np.array([np.inf, 2.5, 2.25]), total_bits=4.75,
                batch_size=4, bytes_on_wire=123.5, payload_bytes=100.0,
                time_on_air_s=1e-3, energy_j=None, se_drift=0.02,
                spans=[["compute", None, 3.0, 4.0]])


def _bucket(pkg):
    return pkg.BucketKey(n_pad=64, mp_pad=16, n_proc=4, t_max=6,
                         transport="ecsq", placement="local", layout="row")


@pytest.mark.parametrize("erasure", [False, True])
@pytest.mark.parametrize("deltas", [False, True])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_codec_request_bytes_interoperate(erasure, deltas, direction):
    kw = _request_fields(erasure, deltas)
    ref = jsv.SolveRequest(prior=jd.BernoulliGauss(0.07, 0.1, 1.5), **kw)
    port = tsv.SolveRequest(prior=td.BernoulliGauss(0.07, 0.1, 1.5), **kw)
    ref_bytes, port_bytes = jcodec.encode_request(ref), \
        tcodec.encode_request(port)
    assert ref_bytes == port_bytes
    if direction == "reference_to_port":
        back = tcodec.decode_request(ref_bytes)
        assert isinstance(back, tsv.SolveRequest)
        assert tcodec.encode_request(back) == ref_bytes
    else:
        back = jcodec.decode_request(port_bytes)
        assert jcodec.encode_request(back) == port_bytes
    for f in ("request_id", "n_proc", "n_iter", "policy", "transport",
              "snr_db", "layout", "measure_wire", "erasure_rate",
              "erasure_model", "erasure_burst", "erasure_seed", "recovery",
              "a_id", "spans"):
        assert getattr(back, f) == kw.get(f, getattr(port, f)), f
    np.testing.assert_array_equal(back.a, kw["a"])


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_codec_result_bytes_interoperate(direction):
    kw = _result_fields()
    ref = jsv.SolveResult(bucket=_bucket(jbk), **kw)
    port = tsv.SolveResult(bucket=_bucket(tsv), **kw)
    ref_bytes, port_bytes = jcodec.encode_result(ref), \
        tcodec.encode_result(port)
    assert ref_bytes == port_bytes
    if direction == "reference_to_port":
        back = tcodec.decode_result(ref_bytes)
        assert isinstance(back.bucket, tsv.BucketKey)
        assert tcodec.encode_result(back) == ref_bytes
    else:
        back = jcodec.decode_result(port_bytes)
        assert jcodec.encode_result(back) == port_bytes
    np.testing.assert_array_equal(back.sigma2_hat, kw["sigma2_hat"])
    assert back.total_bits == kw["total_bits"] and back.energy_j is None


def test_codec_metrics_and_prewarm_spec_interoperate():
    snap = {"metrics": [{"name": "amp_requests_total", "type": "counter",
                         "help": "h", "samples": [[{"layout": "row"}, 3.0]]}]}
    assert tcodec.encode_metrics("host1", snap) == \
        jcodec.encode_metrics("host1", snap)
    assert tcodec.decode_metrics(jcodec.encode_metrics("h", snap)) == \
        ("h", snap)
    kw = dict(n=128, m=64, n_proc=4, n_iter=8, policy="bt", layout="col",
              batch_widths=(4, 8))
    jspec = jsv.PrewarmSpec(prior=jd.BernoulliGauss(0.05), **kw)
    tspec = tsv.PrewarmSpec(prior=td.BernoulliGauss(0.05), **kw)
    assert tcodec.spec_to_dict(tspec) == jcodec.spec_to_dict(jspec)
    assert tcodec.spec_from_dict(jcodec.spec_to_dict(jspec)) == tspec
    with pytest.raises(tcodec.CodecError):
        tcodec.spec_from_dict(dict(tcodec.spec_to_dict(tspec), erasure=True))


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 8), st.integers(1, 8), st.integers(0, 2 ** 31 - 1),
       st.sampled_from(["fixed", "lossless"]),
       st.floats(5.0, 40.0, allow_nan=False), st.floats(0.0, 0.9))
def test_codec_request_roundtrip_property(nq, mq, rid, policy, snr, rate):
    """Any structurally valid request survives the wire bit for bit and
    encodes to the reference's bytes."""
    rng = np.random.default_rng(rid % 1000)
    n, m = 8 * nq, 4 * mq
    deltas = None
    if policy == "fixed":
        deltas = np.full(6, 0.05, np.float32)
        deltas[0] = np.inf
    kw = dict(y=rng.standard_normal(m).astype(np.float32),
              a=rng.standard_normal((m, n)).astype(np.float32), snr_db=snr,
              n_proc=4, n_iter=6, policy=policy, deltas=deltas,
              request_id=rid, erasure_rate=rate, erasure_seed=rid % 97)
    req = tsv.SolveRequest(prior=td.BernoulliGauss(eps=0.1), **kw)
    buf = tcodec.encode_request(req)
    assert buf == jcodec.encode_request(
        jsv.SolveRequest(prior=jd.BernoulliGauss(eps=0.1), **kw))
    back = tcodec.decode_request(buf)
    for f in ("request_id", "snr_db", "erasure_rate", "erasure_seed"):
        assert getattr(back, f) == getattr(req, f)
    np.testing.assert_array_equal(back.a, req.a)


def _frame_with(header_edit=None, arrays_edit=None):
    _, reqs = make_reqs(1)
    header, arrays = tcodec._unpack(tcodec.encode_request(reqs[0]))
    if header_edit:
        header_edit(header)
    if arrays_edit:
        arrays_edit(arrays)
    return tcodec._pack(header, arrays)


BAD_FRAMES = {
    "unknown_field": lambda: _frame_with(lambda h: h.update(no_such=1)),
    "renamed_prior_key": lambda: _frame_with(
        lambda h: h.update(prior={"eps": 0.1, "lu_s": 0.0, "sigma_s": 1.0})),
    "extra_prior_key": lambda: _frame_with(
        lambda h: h["prior"].update(scale=2.0)),
    "prior_not_numbers": lambda: _frame_with(
        lambda h: h["prior"].update(eps="0.1")),
    "prior_not_a_dict": lambda: _frame_with(lambda h: h.update(prior=[1])),
    "missing_kind": lambda: _frame_with(lambda h: h.pop("kind")),
    "missing_array": lambda: _frame_with(arrays_edit=lambda a: a.pop("y")),
    "unknown_array": lambda: _frame_with(
        arrays_edit=lambda a: a.update(z=np.zeros(2, np.float32))),
    "bad_magic": lambda: b"BAD1" + _frame_with()[4:],
    "truncated": lambda: _frame_with()[:-3],
    "trailing": lambda: _frame_with() + b"\0",
}


@pytest.mark.parametrize("name", sorted(BAD_FRAMES))
def test_codec_rejects_with_codec_error_only(name):
    """Every malformed frame is a ``CodecError`` and nothing else — a
    renamed prior key included, which the reference lets escape as a
    ``TypeError`` (its red ``test_codec_fuzz_truncate_corrupt_oversize``)."""
    with pytest.raises(tcodec.CodecError):
        tcodec.decode_request(BAD_FRAMES[name]())


# ---------------------------------------------------------------------------
# scheduler units against the reference's, on the same scripts
# ---------------------------------------------------------------------------

def _key(pkg):
    _, reqs = make_reqs(1)
    r = reqs[0]
    return pkg.routing_key(r, pkg.BucketPolicy(max_batch=8, n_quantum=64,
                                               mp_quantum=8))


def _script(pkg):
    """A scripted routing session; returns every observable decision."""
    pol = pkg.RouterPolicy(min_replicas=2, max_outstanding=3.0,
                           suspect_after=1, dead_after=2)
    r = pkg.ClusterRouter([pkg.HostInfo("a"), pkg.HostInfo("b"),
                           pkg.HostInfo("c")], pol)
    key = _key(pkg)
    out = [r.replicas(key)]
    r.mark_warm("b", key)
    out += [r.route(key, 1.0) for _ in range(4)]
    r.complete("a", 1.0)
    r.mark_suspect("b")
    out += [r.route(key, 1.0), r.host_states()]
    r.mark_dead("b")
    out += [r.replicas(key), r.host_states(), r.route(key, 0.5,
                                                      avoid=frozenset("a"))]
    try:
        for _ in range(5):
            out.append(r.route(key, 1.0))
    except pkg.Overloaded:
        out.append("overloaded")
    r.mark_healthy("b")
    out += [r.add_replica(key), r.remove_replica(key), r.stats()]
    return out


def test_router_script_matches_reference():
    assert _script(tsv) == _script(jsv)


def test_autoscaler_script_matches_reference():
    def run(pkg):
        pol = pkg.RouterPolicy(min_replicas=1, target_load=1.0,
                               down_patience=2, ewma_halflife_s=0.5)
        r = pkg.ClusterRouter([pkg.HostInfo("a"), pkg.HostInfo("b")], pol)
        a = pkg.Autoscaler(r, pol)
        key = _key(pkg)
        a.observe({key: 0}, now=0.0)
        a.observe({key: 1000}, now=1.0)
        ev = [a.step(now=1.0)]
        a.tracker._rate[key] = 0.0
        ev += [a.step(now=2.0), a.step(now=3.0), r.replicas(key),
               a.stats()["events"]]
        return ev
    got, want = run(tsv), run(jsv)
    assert [[tuple(map(str, e)) for e in x] if isinstance(x, list) else x
            for x in got[:3]] == \
        [[tuple(map(str, e)) for e in x] if isinstance(x, list) else x
         for x in want[:3]]
    assert got[3] == want[3] == ["a"]
    assert [e[0] for e in got[4]] == ["scale_up", "scale_down"]


def test_demand_tracker_ewma_decay():
    tr = tsv.DemandTracker(halflife_s=10.0)
    key = _key(tsv)
    tr.update({key: 5}, now=0.0)
    assert tr.rate(key) == 0.0
    tr.update({key: 100}, now=10.0)
    assert tr.rate(key) == pytest.approx(5.0)
    tr.update({}, now=20.0)
    assert tr.rate(key) == pytest.approx(2.5)


def test_router_stats_safe_under_concurrent_routing():
    """Routing, completion and stats reads from many threads (more than
    cores, a short switch interval): every read consistent, the final
    ledger exact."""
    r = tsv.ClusterRouter([tsv.HostInfo("a"), tsv.HostInfo("b")],
                          tsv.RouterPolicy(min_replicas=2))
    key = _key(tsv)
    n_threads, per_thread = 12, 300
    errors, stop = [], threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker():
            try:
                for _ in range(per_thread):
                    r.complete(r.route(key, 1.0), 1.0)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(repr(e))

        def reader():
            while not stop.is_set():
                s = r.stats()
                if any(v < -1e-9 for v in s["outstanding"].values()):
                    errors.append(f"negative outstanding {s}")

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        rd = threading.Thread(target=reader)
        rd.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        stop.set()
        rd.join(JOIN_S)
        assert not any(t.is_alive() for t in threads) and not rd.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    s = r.stats()
    assert s["outstanding"] == {"a": 0.0, "b": 0.0}
    assert sum(s["served"].values()) == n_threads * per_thread


# ---------------------------------------------------------------------------
# ClusterService of in-process hosts against one SolveService
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster_ctx():
    """The same 16-request stream (every 3rd on a lossy link) through one
    service and a 2-host cluster, both prewarmed."""
    prior, reqs = make_reqs(16, erasure_every=3)
    menu = [tsv.PrewarmSpec(n=128, m=64, n_proc=4, n_iter=8, policy="fixed",
                            prior=prior, batch_widths=(8,))]
    ref = _service()
    ref.prewarm(menu)
    base = ref.solve(reqs)
    cl = tsv.ClusterService(n_hosts=2, policy=POL,
                            router_policy=tsv.RouterPolicy(min_replicas=2),
                            rate_accounting=False, device="cpu")
    cl.prewarm(menu)
    warm = cl.compile_count()
    res = sorted(cl.solve(reqs), key=lambda r: r.request_id)
    stats0 = cl.stats()
    yield prior, reqs, base, cl, res, warm, stats0
    cl.close()


def test_cluster_matches_single_host_bitwise(cluster_ctx):
    _, reqs, base, _, res, _, _ = cluster_ctx
    assert len(res) == len(reqs)
    for c, b in zip(res, base):
        assert c.request_id == b.request_id
        for f in ("x", "sigma2_hat", "deltas", "extra_var", "rates"):
            np.testing.assert_array_equal(getattr(c, f), getattr(b, f))


def test_cluster_no_program_after_prewarm(cluster_ctx):
    _, reqs, _, cl, _, warm, _ = cluster_ctx
    assert cl.compile_count() == warm
    cl.solve(reqs[:8])
    assert cl.compile_count() == warm


def test_cluster_balances_hosts(cluster_ctx):
    *_, stats0 = cluster_ctx
    assert stats0["router"]["served"] == {"host0": 8, "host1": 8}
    assert stats0["router"]["imbalance"] == pytest.approx(1.0)
    assert stats0["lost"] == 0 and stats0["failovers"] == 0


def test_cluster_partition_stream_and_global_ids(cluster_ctx):
    _, reqs, base, cl, _, warm, _ = cluster_ctx
    shares = cl.partition(reqs)
    assert sorted(len(s) for s in shares.values()) == [8, 8]
    assert cl.compile_count() == warm
    before = cl.submitted
    got = sorted(cl.stream(iter(reqs)), key=lambda r: r.request_id)
    assert [r.request_id for r in got] == list(range(before,
                                                     before + len(reqs)))
    for c, b in zip(got, base):
        np.testing.assert_array_equal(c.x, b.x)


def test_cluster_metrics_families(cluster_ctx):
    *_, cl, _, _, _ = cluster_ctx
    names = {m["name"] for m in cl.metrics()["metrics"]}
    assert {"amp_cluster_submitted_total", "amp_cluster_inflight",
            "amp_router_served_total", "amp_router_imbalance",
            "amp_autoscaler_events_total", "amp_host_state",
            "amp_requests_total"} <= names
    assert "amp_cluster_submitted_total" in cl.metrics_text()


def test_cluster_sheds_and_counts():
    _, reqs = make_reqs(16)
    key = tsv.routing_key(reqs[0], POL)
    cl = tsv.ClusterService(
        n_hosts=2, policy=POL, rate_accounting=False, device="cpu",
        router_policy=tsv.RouterPolicy(
            min_replicas=2, max_outstanding=2.5 * tsv.shape_cost(key)))
    admitted = shed = 0
    for r in reqs:
        try:
            cl.submit(r)
            admitted += 1
        except tsv.Overloaded:
            shed += 1
    assert shed > 0 and admitted == 6
    assert cl.stats()["shed"] == shed
    assert len(cl.flush()) == admitted
    cl.close()


def test_cluster_autoscaler_prewarms_new_replica():
    _, reqs = make_reqs(8)
    cl = tsv.ClusterService(
        n_hosts=2, policy=POL, rate_accounting=False, device="cpu",
        router_policy=tsv.RouterPolicy(min_replicas=1, target_load=0.01,
                                       ewma_halflife_s=0.5))
    cl.scrape(now=100.0)
    cl.solve(reqs)
    key = tsv.routing_key(reqs[0], POL)
    assert cl.router.replicas(key) == ["host0"]
    before = cl.backends["host1"].compile_count()
    events = cl.scrape(now=101.0)
    assert ("scale_up", key, "host1") in events
    assert cl.backends["host1"].compile_count() > before
    cl.close()


def test_scraper_daemon_thread_scales_up_and_stops():
    _, reqs = make_reqs(8)
    cl = tsv.ClusterService(
        n_hosts=2, policy=POL, rate_accounting=False, device="cpu",
        router_policy=tsv.RouterPolicy(min_replicas=1, target_load=0.01,
                                       ewma_halflife_s=0.2))
    try:
        key = tsv.routing_key(reqs[0], POL)
        th = cl.start_scraper(interval_s=0.05)
        assert th.daemon and cl.start_scraper() is th
        deadline = time.monotonic() + 5.0
        while (cl.autoscaler.tracker._t_last is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        cl.solve(reqs)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if (any(e[0] == "scale_up" for e in cl.autoscaler.events)
                    and cl.backends["host1"].compile_count() > 0):
                break
            time.sleep(0.05)
        assert cl.router.replicas(key) == ["host0", "host1"]
        assert cl.scrape_errors == []
        cl.stop_scraper()
        assert cl._scrape_thread is None and not th.is_alive()
    finally:
        cl.close()


def test_cluster_defaults_to_the_card(monkeypatch):
    """``ClusterService(n_hosts=k)`` builds its services on the card by
    default, and raises without one."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.ClusterService(n_hosts=2)


# ---------------------------------------------------------------------------
# TCP: a BackendServer on a loopback socket
# ---------------------------------------------------------------------------

def test_tcp_backend_roundtrip(cluster_ctx):
    prior, reqs, base, *_ = cluster_ctx
    server = BackendServer(LocalBackend("host1", _service()),
                           idle_timeout_s=30.0)
    server.start()
    try:
        tcp = TcpBackend((server.host, server.port), "host1",
                         connect_timeout_s=5.0, recv_timeout_s=60.0)
        assert tcp.n_devices == 1 and tcp.ping()
        cl = tsv.ClusterService(
            backends=[LocalBackend("host0", _service()), tcp], policy=POL,
            router_policy=tsv.RouterPolicy(min_replicas=2))
        menu = [tsv.PrewarmSpec(n=128, m=64, n_proc=4, n_iter=8,
                                policy="fixed", prior=prior,
                                batch_widths=(8,))]
        rep = cl.prewarm(menu)
        assert rep["host1"]["programs"] >= 1
        got = sorted(cl.solve(reqs), key=lambda r: r.request_id)
        for c, b in zip(got, base):
            np.testing.assert_array_equal(c.x, b.x)
        assert cl.router.stats()["served"]["host1"] > 0
        assert cl.stats()["hosts"]["host1"]["compiles"]["total"] >= 1
        rtt = cl.rtt_stats()["host1"]
        assert rtt["S"]["count"] >= 1 and rtt["S"]["p50_ms"] > 0
        names = {m["name"] for m in cl.metrics()["metrics"]}
        assert "amp_tcp_rtt_p50_seconds" in names
        with pytest.raises(tsv.RemoteRequestError):
            tcp.prewarm([dataclasses.replace(menu[0], n=13, m=7)])
        assert tcp.ping()                          # the connection survived
        cl.close(shutdown_remote=True)
        assert server.join(JOIN_S)
    finally:
        server.stop()
        assert server.join(JOIN_S)


def test_tcp_backend_submit_poll_cycle():
    _, reqs = make_reqs(3, seed=50)
    server = BackendServer(LocalBackend("h", _service()), idle_timeout_s=30.0)
    server.start()
    try:
        tcp = TcpBackend((server.host, server.port), "h",
                         connect_timeout_s=5.0, recv_timeout_s=60.0)
        ids = [tcp.submit(r) for r in reqs]
        assert ids == [0, 1, 2]
        assert sorted(r.request_id for r in tcp.flush()) == ids
        assert tcp.take_demand() != {}
        assert tcp.take_demand() == {}
        tcp.shutdown_server()
        assert server.join(JOIN_S)
    finally:
        server.stop()


@pytest.mark.parametrize("kw", [{"connect_timeout_s": 0.0},
                                {"recv_timeout_s": float("inf")}])
def test_tcp_backend_refuses_unbounded_timeouts(kw):
    with pytest.raises(ValueError, match="timeout"):
        TcpBackend(("127.0.0.1", 9), "h", **kw)


def test_backend_server_refuses_unbounded_idle():
    with pytest.raises(ValueError, match="idle_timeout_s"):
        BackendServer(LocalBackend("h", _service()), idle_timeout_s=0)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chaos", [False, True], ids=["smoke", "chaos"])
def test_multihost_launcher_two_processes(chaos):
    """``python -m repro_torch.launch.multihost --smoke`` on the CPU: a
    child process behind a ``BackendServer`` reached by ``TcpBackend``
    gives the single host's bits, no program after prewarm; ``--chaos``
    kills it mid-flight and loses nothing."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("AMP_PROCESS_ID", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost", "--smoke",
           "--device", "cpu", "--timeout", "150"]
    out = subprocess.run(cmd + (["--chaos"] if chaos else []), env=env,
                         capture_output=True, text=True, timeout=200)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "max|dx| 0.0e+00" in out.stdout and "programs after prewarm 0" \
        in out.stdout
    assert "frame rtt" in out.stdout
    if chaos:
        assert "lost 0" in out.stdout and "'host1': 'dead'" in out.stdout
