"""The port's fault-tolerance plane on the CPU: the host state machine, the
seeded fault plans (the same storms as the reference's from one seed), the
frame layer and the codec under corruption (only ``CodecError`` escapes),
the TCP failure modes through ``ChaosProxy``, and the chaos drills — a host
killed mid-stream or mid-flush loses nothing and the replay gives the
single host's bits — plus health probes, hedging and the shed ladder.

Every socket has a timeout and every thread is joined with a deadline; a
test that waits does so in a loop with a deadline.
"""
import dataclasses
import socket
import struct
import time
from collections import deque

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.serving as jsv
import repro_torch.serving as tsv
from repro_torch.serving import (BackendError, BackendUnavailable,
                                 ChaosBackend, ChaosProxy, ClusterService,
                                 FaultPlan, FaultSpec, FrameError, Overloaded,
                                 RemoteRequestError, RouterPolicy, ShedLadder,
                                 routing_key, shape_cost)
from repro_torch.serving.codec import CodecError, decode_request, encode_request
from repro_torch.serving.frontend import (BackendServer, LocalBackend,
                                          TcpBackend, _unpack_results)
from repro_torch.serving.wire import recv_exact, recv_frame, send_frame

from test_torch_cluster import POL, make_reqs

JOIN_S = 10.0


def local_host(hid: str) -> LocalBackend:
    return LocalBackend(hid, tsv.SolveService(policy=POL,
                                              rate_accounting=False,
                                              device="cpu"))


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


# ---------------------------------------------------------------------------
# host state machine
# ---------------------------------------------------------------------------

def three_host_router(**kw):
    return tsv.ClusterRouter([tsv.HostInfo("a"), tsv.HostInfo("b"),
                              tsv.HostInfo("c")], RouterPolicy(**kw))


def any_key():
    _, reqs = make_reqs(1)
    return routing_key(reqs[0], POL)


def test_router_state_machine_transitions():
    r = three_host_router()
    assert set(r.host_states().values()) == {"healthy"}
    r.mark_suspect("a")
    assert r.host_state("a") == "suspect"
    r.mark_healthy("a")
    r.mark_dead("a")
    r.mark_suspect("a")                      # dead does not regress
    assert r.host_state("a") == "dead"
    r.mark_healthy("a")                      # explicit revival
    assert r.host_state("a") == "healthy"
    r.drain("b")
    assert r.host_state("b") == "draining"


@pytest.mark.parametrize("case", ["dead_refill", "all_dead", "suspect_ties",
                                  "avoid_all"])
def test_router_failure_routing(case):
    key = any_key()
    if case == "dead_refill":
        r = three_host_router(min_replicas=2)
        r.route(key, 1.0)
        assert set(r.replicas(key)) == {"a", "b"}
        r.mark_dead("a")
        assert "a" not in r.replicas(key)
        assert r.stats()["outstanding"]["a"] == 0.0
        assert "a" not in {r.route(key, 1.0) for _ in range(4)}
        assert "c" in r.replicas(key)
    elif case == "all_dead":
        r = three_host_router()
        for hid in "abc":
            r.mark_dead(hid)
        with pytest.raises(Overloaded):
            r.route(key, 1.0)
    elif case == "suspect_ties":
        r = three_host_router(min_replicas=3)
        r.mark_suspect("a")
        assert r.route(key, 1.0) in ("b", "c")
        r.mark_dead("b")
        r.mark_dead("c")
        assert r.route(key, 1.0) == "a"
    else:
        r = three_host_router(min_replicas=1)
        assert r.route(key, 1.0, avoid=frozenset("abc")) in ("a", "b", "c")


# ---------------------------------------------------------------------------
# fault plans and the call-boundary harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_same_storm_as_reference(seed):
    """``FaultPlan.random`` draws from ``random.Random(seed)`` in the
    reference's order: the same faults at the same calls."""
    got = tsv.FaultPlan.random(seed, n_faults=4, horizon=40)
    want = jsv.FaultPlan.random(seed, n_faults=4, horizon=40)
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert got == tsv.FaultPlan.random(seed, n_faults=4, horizon=40)


def test_fault_plan_validated():
    plan = FaultPlan.kill_at(3, ops=("submit",))
    assert plan.fault_for("submit", 3).kind == "kill"
    assert plan.fault_for("poll", 3) is None
    with pytest.raises(ValueError):
        FaultSpec("melt", 1)
    with pytest.raises(ValueError):
        FaultSpec("kill", 0)


def test_chaos_backend_kill_error_freeze():
    plan = FaultPlan(faults=(FaultSpec("error", 1),
                             FaultSpec("freeze", 2, duration_s=0.5),
                             FaultSpec("kill", 3)))
    naps = []
    cb = ChaosBackend(local_host("h"), plan, sleep=naps.append)
    assert cb.host_id == "h" and cb.n_devices == 1
    with pytest.raises(RemoteRequestError):
        cb.ping()
    with pytest.raises(BackendUnavailable):
        cb.ping()
    with pytest.raises(BackendUnavailable):
        cb.ping()
    with pytest.raises(BackendUnavailable):
        cb.poll()
    cb.revive()
    assert cb.ping() is True
    assert naps == [0.5]
    assert [k for _, _, k in cb.faults_fired] == ["error", "freeze", "kill"]


# ---------------------------------------------------------------------------
# frames and the codec under corruption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 70000])
def test_frame_roundtrip(size):
    a, b = _pair()
    try:
        send_frame(a, b"R", b"x" * size)
        assert recv_frame(b) == (b"R", b"x" * size)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("length", [0, (1 << 30) + 1])
def test_frame_bad_length_is_frame_error(length):
    a, b = _pair()
    try:
        a.sendall(struct.pack("<I", length))
        with pytest.raises(FrameError):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_frame_truncated_stream_raises_connection_error():
    a, b = _pair()
    try:
        a.sendall(struct.pack("<I", 100) + b"S" + b"only-ten")
        a.close()
        with pytest.raises(ConnectionError):
            recv_frame(b)
    finally:
        b.close()


def test_every_read_is_bounded():
    """``recv_exact`` refuses a socket without a timeout, and times out on
    a silent peer instead of waiting for ever."""
    a, b = socket.socketpair()
    try:
        b.settimeout(None)
        with pytest.raises(ValueError, match="timeout"):
            recv_exact(b, 4)
        b.settimeout(0.2)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            recv_exact(b, 4)
        assert time.monotonic() - t0 < 2.0
    finally:
        a.close()
        b.close()


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_codec_fuzz_truncate_corrupt_oversize(data):
    """Any mutation of a valid request frame — a bit flip anywhere in the
    header (a prior key renamed included), a truncation, trailing bytes —
    either decodes or raises ``CodecError``: nothing else escapes. (The
    reference's test of the same name is red: its prior decoder lets a
    renamed key escape as a ``TypeError``.)"""
    rng = np.random.default_rng(0)
    req = tsv.SolveRequest(y=rng.standard_normal(8).astype(np.float32),
                           a=rng.standard_normal((8, 16)).astype(np.float32),
                           n_proc=2, n_iter=3, erasure_rate=0.1)
    buf = bytearray(encode_request(req))
    mode = data.draw(st.sampled_from(["truncate", "flip", "grow"]))
    if mode == "truncate":
        buf = buf[:data.draw(st.integers(0, len(buf) - 1))]
    elif mode == "flip":
        i = data.draw(st.integers(0, min(400, len(buf) - 1)))
        buf[i] ^= data.draw(st.integers(1, 255))
    else:
        buf += bytes(data.draw(st.integers(1, 64)))
    try:
        decode_request(bytes(buf))
    except CodecError:
        pass


def test_codec_fuzz_every_header_byte_flip():
    """The fuzz test's flips, exhaustively over the header: every byte of
    it XORed with each of three masks."""
    _, reqs = make_reqs(1)
    buf = encode_request(reqs[0])
    (hlen,) = struct.unpack("<I", buf[4:8])
    escaped = []
    for i in range(8 + hlen):
        for mask in (1, 0x20, 0x80):
            b = bytearray(buf)
            b[i] ^= mask
            try:
                decode_request(bytes(b))
            except CodecError:
                pass
            except Exception as e:  # noqa: BLE001 - what the test looks for
                escaped.append((i, mask, type(e).__name__))
    assert escaped == []


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=64), st.integers(0, 2 ** 32 - 1))
def test_result_list_fuzz(tail, count):
    try:
        _unpack_results(struct.pack("<I", count) + tail)
    except CodecError:
        pass


# ---------------------------------------------------------------------------
# TCP failure modes
# ---------------------------------------------------------------------------

def test_tcp_connect_refused_is_backend_unavailable():
    s = socket.create_server(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    t0 = time.monotonic()
    with pytest.raises(BackendUnavailable):
        TcpBackend(addr, "ghost", connect_timeout_s=2.0)
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("mode", ["stall", "sever"])
def test_tcp_dead_peer_fails_within_budget(mode):
    """Through a ``ChaosProxy``: a peer that stalls mid-reply fails the
    call within the recv timeout; a severed one at once; both as
    ``BackendUnavailable``."""
    server = BackendServer(local_host("h"), idle_timeout_s=30.0)
    server.start()
    proxy = ChaosProxy((server.host, server.port)).start()
    try:
        tcp = TcpBackend(proxy.address, "h", connect_timeout_s=2.0,
                         recv_timeout_s=0.5)
        assert tcp.ping()
        proxy.trip(mode)
        t0 = time.monotonic()
        with pytest.raises(BackendUnavailable):
            tcp.ping()
        assert time.monotonic() - t0 < 3.0
        tcp.close()
    finally:
        proxy.stop()
        server.stop()
        assert server.join(JOIN_S)


def test_tcp_remote_error_carries_traceback_and_connection_survives():
    server = BackendServer(local_host("h"), idle_timeout_s=30.0)
    server.start()
    try:
        tcp = TcpBackend((server.host, server.port), "h",
                         connect_timeout_s=5.0, recv_timeout_s=60.0)
        bad = tsv.PrewarmSpec(n=13, m=7, n_proc=4, n_iter=8, policy="fixed")
        with pytest.raises(RemoteRequestError) as ei:
            tcp.prewarm([bad])
        assert ei.value.host_id == "h"
        assert "Traceback" in ei.value.remote_traceback
        assert isinstance(ei.value, BackendError)
        assert not isinstance(ei.value, BackendUnavailable)
        assert tcp.ping()
        _, reqs = make_reqs(1, seed=77)
        assert tcp.submit(reqs[0]) == 0
        assert len(tcp.flush()) == 1
        tcp.shutdown_server()
        assert server.join(JOIN_S)
    finally:
        server.stop()


def test_tcp_kill_server_op_stops_listener():
    server = BackendServer(local_host("h"), idle_timeout_s=30.0)
    server.start()
    try:
        tcp = TcpBackend((server.host, server.port), "h",
                         connect_timeout_s=2.0, recv_timeout_s=5.0)
        tcp.kill_server()
        assert server.join(JOIN_S)
        with pytest.raises(BackendUnavailable):
            TcpBackend((server.host, server.port), "h",
                       connect_timeout_s=1.0)
    finally:
        server.stop()


def test_backend_server_stop_ends_a_served_connection():
    """``stop()`` with a frontend still connected (and silent) ends the
    serving thread at once, not after the idle timeout."""
    server = BackendServer(local_host("h"), idle_timeout_s=120.0)
    server.start()
    tcp = TcpBackend((server.host, server.port), "h", connect_timeout_s=2.0,
                     recv_timeout_s=5.0)
    assert tcp.ping()
    t0 = time.monotonic()
    server.stop()
    assert server.join(JOIN_S) and time.monotonic() - t0 < 5.0
    tcp.close()


# ---------------------------------------------------------------------------
# the chaos drills
# ---------------------------------------------------------------------------

def chaos_cluster(plan: FaultPlan, **rp_kw):
    rp = dict(min_replicas=2, suspect_after=1, dead_after=2, retry_limit=2,
              retry_backoff_s=0.0)
    rp.update(rp_kw)
    return ClusterService(
        backends=[local_host("host0"), ChaosBackend(local_host("host1"),
                                                    plan)],
        policy=POL, router_policy=RouterPolicy(**rp))


@pytest.fixture(scope="module")
def base_run():
    """A 16-request stream, every 4th on a lossy link, on one service."""
    _, reqs = make_reqs(16, erasure_every=4)
    svc = tsv.SolveService(policy=POL, rate_accounting=False, device="cpu")
    return reqs, svc.solve(reqs)


@pytest.mark.parametrize("when", ["mid_stream", "during_flush"])
def test_chaos_kill_one_host_zero_loss_bit_identical(when, base_run):
    """host1 dies on its 5th call (4 requests stranded in its open batch)
    or on its 9th (its first flush: a full batch of 8 stranded): every
    admitted request completes, the replay gives the single host's bits,
    host1 is evicted, recovery latency is recorded, and the
    fault-tolerance series surface in the metrics."""
    reqs, base = base_run
    cl = chaos_cluster(FaultPlan.kill_at(5 if when == "mid_stream" else 9),
                       **({} if when == "mid_stream" else {"dead_after": 1}))
    got = sorted(cl.solve(reqs), key=lambda r: r.request_id)
    assert len(got) == len(reqs)
    st_ = cl.stats()
    assert st_["lost"] == 0 and st_["failovers"] == 1 and st_["retries"] > 0
    assert st_["host_states"]["host1"] == "dead"
    assert st_["recovery"]["count"] >= 1
    for c, b in zip(got, base):
        assert c.request_id == b.request_id
        for f in ("x", "sigma2_hat", "deltas", "extra_var", "rates"):
            np.testing.assert_array_equal(getattr(c, f), getattr(b, f))
    names = {m["name"] for m in cl.metrics()["metrics"]}
    assert {"amp_failover_total", "amp_retry_total",
            "amp_lost_requests_total", "amp_host_state",
            "amp_recovery_seconds", "amp_heartbeat_failures_total"} <= names
    cl.close()


def test_chaos_all_hosts_dead_raises_not_hangs():
    _, reqs = make_reqs(4)
    cl = ClusterService(
        backends=[ChaosBackend(local_host("host0"), FaultPlan.kill_at(1)),
                  ChaosBackend(local_host("host1"), FaultPlan.kill_at(1))],
        policy=POL,
        router_policy=RouterPolicy(min_replicas=2, suspect_after=1,
                                   dead_after=1, retry_limit=1,
                                   retry_backoff_s=0.0))
    with pytest.raises((BackendUnavailable, Overloaded)):
        cl.solve(reqs)
    assert set(cl.stats()["host_states"].values()) == {"dead"}
    cl.close()


def test_check_health_walks_suspect_to_dead_and_revives():
    cl = chaos_cluster(FaultPlan.kill_at(1, ops=("ping",)), suspect_after=1,
                       dead_after=3)
    assert [cl.check_health()["host1"] for _ in range(3)] == \
        ["suspect", "suspect", "dead"]
    assert cl.check_health()["host0"] == "healthy"
    assert cl.stats()["failovers"] == 1
    cl.backends["host1"].revive()
    assert cl.check_health()["host1"] == "healthy"
    _, reqs = make_reqs(2, seed=30)
    assert len(cl.solve(reqs)) == 2
    cl.close()


def test_hedge_duplicates_tail_and_dedupes():
    _, reqs = make_reqs(1, seed=9)
    cl = ClusterService(
        backends=[local_host("host0"), local_host("host1")], policy=POL,
        router_policy=RouterPolicy(min_replicas=2, hedge_p99_mult=2.0))
    key = routing_key(reqs[0], POL)
    cl._lat[key] = deque([0.001] * 8)
    gid = cl.submit(reqs[0])
    (_, fl), = cl._inflight.items()
    fl.t_submit -= 10.0
    cl.poll()
    assert cl.hedges == 1 and len(cl._inflight) == 2
    got = cl.flush()
    assert [r.request_id for r in got] == [gid]
    assert cl._inflight == {} and cl._zombies == {}
    assert cl.stats()["router"]["outstanding"] == {"host0": 0.0,
                                                   "host1": 0.0}
    cl.close()


def test_shed_ladder_escalates_and_relaxes():
    t = [0.0]
    lad = ShedLadder(window_s=1.0, up_after=3, clock=lambda: t[0])
    for _ in range(6):
        lad.record_shed()
    assert lad.level == 2
    t[0] = 0.5
    assert lad.relax() == 2
    t[0] = 1.6
    assert lad.relax() == 1
    t[0] = 3.0
    assert lad.relax() == 0
    for i in range(10):
        t[0] = 10.0 + 2.0 * i
        lad.record_shed()
    assert lad.level == 0


def test_shed_ladder_quotes_against_the_reference():
    """Level 2 halves the budget and quotes the SE MSE at both budgets;
    the port's quote equals the reference's (the same SE)."""
    _, reqs = make_reqs(1)
    req = reqs[0]
    lad, jlad = ShedLadder(), jsv.ShedLadder()
    lad.level = jlad.level = 2
    r2, q2 = lad.apply(req)
    jreq = jsv.SolveRequest(y=req.y, a=req.a, n_proc=4, n_iter=8,
                            policy="fixed", deltas=req.deltas)
    _, jq2 = jlad.apply(jreq)
    assert r2.n_iter == 4 and len(r2.deltas) == 4
    assert q2["mse_degraded"] >= q2["mse_full"] > 0.0
    assert q2["mse_full"] == pytest.approx(jq2["mse_full"], rel=1e-9)
    assert q2["mse_degraded"] == pytest.approx(jq2["mse_degraded"], rel=1e-9)


def test_shed_ladder_degraded_requests_still_solve():
    _, reqs = make_reqs(6)
    key = routing_key(reqs[0], POL)
    cl = ClusterService(
        n_hosts=1, policy=POL, rate_accounting=False, device="cpu",
        router_policy=RouterPolicy(min_replicas=1, shed_ladder=True,
                                   max_outstanding=2.5 * shape_cost(key)))
    cl._ladder.level = 2
    done = 0
    for r in reqs[:2]:
        try:
            cl.submit(r)
            done += 1
        except Overloaded:
            pass
    got = cl.flush()
    assert len(got) == done == 2
    st_ = cl.stats()
    assert st_["degraded"] == 2 and st_["shed_ladder_level"] == 2
    cl.close()
