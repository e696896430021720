"""Cluster frontend: admission, host backends, and the user-facing
``ClusterService`` (the port of the JAX package's
``repro.serving.frontend``; its DESIGN.md §11 and §13 describe the design).

The frontend half of the frontend/scheduler/backend split. A
``ClusterService`` owns

  * a set of **backends** — each one a ``SolveService`` on its own host
    (``LocalBackend`` in-process, e.g. one per emulated host on a dev
    box, or ``TcpBackend`` speaking the no-pickle ``serving.codec`` frame
    protocol to a ``BackendServer`` in another process,
    ``launch/multihost.py``),
  * the **scheduler** (``serving.router``): a ``ClusterRouter`` placing
    placement-agnostic bucket keys onto hosts by load × shape, and an
    ``Autoscaler`` moving per-bucket replica counts from demand EWMAs
    scraped out of each backend's ``Batcher.take_demand`` window,
  * **admission**: global request ids, per-host outstanding-cost caps
    (shed with ``Overloaded`` when every replica of a bucket is
    saturated), and the id rewrite between backend-local and global
    request ids.

The per-host dispatch-ahead overlap is untouched — each backend's
``SolveService`` still launches engine calls asynchronously and the
frontend only ``poll``s materialized results — so the cluster tier adds
routing, not synchronization, to the hot path. A result crosses to the
frontend as numpy on the host: the one device sync of a request is the
backend's, when its result is finished, outside any solve loop.

Every socket here has a timeout and every thread a bounded join: the
listener wakes every ``ACCEPT_POLL_S`` to see ``stop()``, a served
connection times out after ``idle_timeout_s``, and ``TcpBackend`` bounds
connect and each read by ``connect_timeout_s`` / ``recv_timeout_s``.

Cross-host byte traffic is exactly the codec frames: requests/results
never pickle, and the measured ``bytes_on_wire`` accounting of
DESIGN.md §10 stays per-request inside each backend.
"""
from __future__ import annotations

import dataclasses
import json
import math
import socket
import struct
import threading
import time
from collections import deque

from ..core.state_evolution import se_trajectory
from ..telemetry import MetricsRegistry, merge_snapshots, prometheus_text
from ..telemetry.metrics import HOST_STATES, RECOVERY_BUCKETS
from ..telemetry.spans import now as _tnow
from ..telemetry.spans import span as _tspan
from ..telemetry.spans import tag_host
from .buckets import BucketPolicy
from .codec import (CodecError, bucket_from_dict, bucket_to_dict,
                    decode_metrics, decode_request, decode_result,
                    encode_metrics, encode_request, encode_result,
                    spec_from_dict, spec_to_dict)
from .router import (Autoscaler, ClusterRouter, HostInfo, Overloaded,
                     RouterPolicy, routing_key, shape_cost)
from .service import PrewarmSpec, SolveService
from .wire import (BackendError, BackendUnavailable, FrameError,
                   RemoteRequestError, pack_error, recv_frame, remote_error,
                   send_frame)

__all__ = ["LocalBackend", "BackendServer", "TcpBackend", "ClusterService",
           "ShedLadder", "Overloaded", "BackendError", "BackendUnavailable",
           "RemoteRequestError"]

ACCEPT_POLL_S = 0.2     # the listener's accept timeout: how soon stop() lands


class LocalBackend:
    """One in-process host: a ``SolveService`` (its own engines, operand
    cache, batcher, on its own device) behind the backend interface the
    frontend routes to."""

    def __init__(self, host_id: str, service: SolveService):
        self.host_id = host_id
        self.service = service

    @property
    def n_devices(self) -> int:
        return self.service.n_devices

    def submit(self, req) -> int:
        return self.service.submit(req)

    def poll(self) -> list:
        return self.service.poll()

    def flush(self) -> list:
        return self.service.flush()

    def take_demand(self) -> dict:
        return self.service.take_demand()

    def prewarm(self, menu) -> dict:
        return self.service.prewarm(menu)

    def stats(self) -> dict:
        return self.service.stats()

    def compile_count(self) -> int:
        return self.service.compile_count()

    def metrics(self) -> dict:
        return self.service.metrics()

    def ping(self) -> bool:
        """Health probe (DESIGN.md §13): in-process backends are alive by
        construction — the interesting implementation is TcpBackend's."""
        return True

    def close(self) -> None:
        pass


# -- TCP transport (codec frames over serving.wire frames) -------------------
#
# Frame protocol lives in ``serving.wire`` (send_frame/recv_frame + the
# typed error frames). Result lists nest as
# u32 count | (u32 len | result-frame)*.


def _pack_results(results) -> bytes:
    frames = [encode_result(r) for r in results]
    return b"".join([struct.pack("<I", len(frames))]
                    + [struct.pack("<I", len(f)) + f for f in frames])


def _unpack_results(body: bytes) -> list:
    """Decode a nested result-list body; every truncation or bad length
    raises ``CodecError`` instead of surfacing as a struct/index crash —
    a corrupt reply must read as a protocol failure, never hang or
    half-deserialize."""
    if len(body) < 4:
        raise CodecError("truncated result list (no count)")
    (count,) = struct.unpack("<I", body[:4])
    off, out = 4, []
    for i in range(count):
        if len(body) < off + 4:
            raise CodecError(f"truncated result list at entry {i}")
        (ln,) = struct.unpack("<I", body[off:off + 4])
        off += 4
        if len(body) < off + ln:
            raise CodecError(f"truncated result frame {i}")
        out.append(decode_result(body[off:off + ln]))
        off += ln
    if off != len(body):
        raise CodecError(f"{len(body) - off} trailing bytes in result list")
    return out


class _Die(Exception):
    """Raised by the ``X`` op: abrupt server death for chaos drills —
    the connection closes with NO reply frame, exactly what a crashed
    process looks like from the frontend."""


class BackendServer:
    """Serves one ``LocalBackend`` over TCP to a remote frontend. One
    frontend connection at a time (the cluster has exactly one router);
    runs on a daemon thread via ``start()``. The ``Q`` op (or ``stop()``)
    shuts it down.

    Fault model (DESIGN.md §13): per-request failures (a bad request,
    a solve raising) reply with a typed error frame carrying the remote
    traceback and the connection survives; backend-fatal conditions
    (resource exhaustion, a desynced frame stream, a frontend that went
    silent past ``idle_timeout_s``) close the connection — the listener
    keeps accepting, so a restarted frontend can reconnect.

    The listener waits in ``accept`` at most ``ACCEPT_POLL_S`` at a time,
    so ``stop()`` ends ``serve_forever`` within that; ``join`` waits for
    the serving thread with a deadline."""

    #: per-request errors keep the connection; these close it
    FATAL_ERRORS = (MemoryError,)

    def __init__(self, backend: LocalBackend, host: str = "127.0.0.1",
                 port: int = 0, idle_timeout_s: float = 300.0):
        if not idle_timeout_s > 0:
            raise ValueError("idle_timeout_s must be > 0: every read of "
                             "the server is bounded")
        self.backend = backend
        self.idle_timeout_s = float(idle_timeout_s)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self._sock.settimeout(ACCEPT_POLL_S)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._conn = None           # the connection being served
        self.frames_served = 0

    def start(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever,
                              name=f"backend-{self.backend.host_id}",
                              daemon=True)
        self._thread = th
        th.start()
        return th

    def stop(self) -> None:
        """Stop serving: close the listener and shut the connection being
        served, so a serve loop blocked in a read ends now."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def join(self, timeout: float = 10.0) -> bool:
        """Wait at most ``timeout`` s for the serving thread; True when it
        has ended (or never started)."""
        th = self._thread
        if th is not None:
            th.join(timeout)
            return not th.is_alive()
        return True

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue   # wake to look at the stop flag
            except OSError:
                break   # listener closed by stop()
            with conn:
                self._conn = conn
                try:
                    self._serve_conn(conn)
                except _Die:
                    self.stop()   # chaos kill: no reply, no cleanup frame
                    break
                except (ConnectionError, OSError):
                    continue   # frontend went away; await the next one
                finally:
                    self._conn = None
        try:
            self._sock.close()
        except OSError:
            pass

    def _serve_conn(self, conn) -> None:
        # a frontend that dies mid-frame must not pin the (single-
        # connection) server forever: time out and await the next one
        conn.settimeout(self.idle_timeout_s)
        while not self._stop.is_set():
            try:
                op, body = recv_frame(conn)
            except FrameError as e:
                # desynced stream: nothing after this frame can be
                # trusted — tell the peer (best effort) and drop the
                # connection so it reconnects clean
                try:
                    send_frame(conn, b"E", pack_error(e, fatal=True))
                except OSError:
                    pass
                return
            try:
                reply = self._dispatch(op, body)
            except _Die:
                raise
            except self.FATAL_ERRORS as e:
                try:
                    send_frame(conn, b"E", pack_error(e, fatal=True))
                except OSError:
                    pass
                return
            except Exception as e:   # per-request: typed frame, carry on
                send_frame(conn, b"E", pack_error(e, fatal=False))
                self.frames_served += 1
                continue
            send_frame(conn, b"R", reply)
            self.frames_served += 1
            if op == b"Q":
                self.stop()
                return

    def _dispatch(self, op: bytes, body: bytes) -> bytes:
        b = self.backend
        if op == b"S":
            return struct.pack("<q", b.submit(decode_request(body)))
        if op == b"P":
            return _pack_results(b.poll())
        if op == b"F":
            return _pack_results(b.flush())
        if op == b"D":
            return json.dumps([[bucket_to_dict(k), v]
                               for k, v in b.take_demand().items()]).encode()
        if op == b"W":
            menu = [spec_from_dict(d) for d in json.loads(body)]
            return json.dumps(b.prewarm(menu)).encode()
        if op == b"T":
            return json.dumps(b.stats()).encode()
        if op == b"C":
            return json.dumps(b.compile_count()).encode()
        if op == b"N":
            return json.dumps(b.n_devices).encode()
        if op == b"M":
            # per-host metrics ride the no-pickle codec as their own
            # frame kind (DESIGN.md §12); the frontend merges them
            return encode_metrics(b.host_id, b.metrics())
        if op == b"H":
            # health probe: proves the serve loop is responsive, not
            # just that the TCP stack accepts connections
            return b"ok"
        if op == b"X":
            raise _Die()
        if op == b"Q":
            return b"ok"
        raise ValueError(f"unknown op {op!r}")


class TcpBackend:
    """Frontend-side proxy for a ``BackendServer`` in another process
    (``launch/multihost.py``). Thread-safe: one request/reply in flight
    per connection.

    Fault handling (DESIGN.md §13): connect and recv both honor
    configurable timeouts — a half-dead peer fails the call with
    ``BackendUnavailable`` within ``recv_timeout_s`` instead of hanging
    forever — and every connection-level failure drops the socket, so
    the next call reconnects (a recovered host rejoins without a new
    proxy object). Remote error frames rebuild as typed exceptions
    (``RemoteRequestError`` with the remote traceback, or
    ``BackendUnavailable`` for backend-fatal replies).

    Every frame's round-trip (send -> reply parsed off the socket) is
    timed into a per-op sliding window — the measured TCP routing
    overhead (``rtt_stats``; surfaced in cluster metrics). Both timeouts
    must be finite and positive: no call waits without a bound."""

    RTT_WINDOW = 4096   # samples kept per op (bounded memory under load)

    def __init__(self, address: "tuple[str, int]", host_id: str,
                 connect_timeout_s: float = 10.0,
                 recv_timeout_s: float = 120.0):
        if not (0 < connect_timeout_s < math.inf
                and 0 < recv_timeout_s < math.inf):
            raise ValueError("connect_timeout_s and recv_timeout_s must be "
                             "finite and > 0")
        self.host_id = host_id
        self.address = tuple(address)
        self.connect_timeout_s = float(connect_timeout_s)
        self.recv_timeout_s = float(recv_timeout_s)
        self._sock = None
        self._lock = threading.Lock()
        self._rtt: dict = {}
        try:
            self.n_devices = int(self._call(b"N", json.loads))
        except BaseException:
            # don't leak the connected socket when the handshake fails
            self.close()
            raise

    def _ensure_sock(self):
        """Connected socket, reconnecting after a dropped one (recovered
        hosts rejoin on the next call). Caller holds ``_lock``."""
        if self._sock is None:
            try:
                sock = socket.create_connection(
                    self.address, timeout=self.connect_timeout_s)
            except OSError as e:
                raise BackendUnavailable(
                    f"backend {self.host_id} connect "
                    f"{self.address}: {e}") from e
            sock.settimeout(self.recv_timeout_s)
            self._sock = sock
        return self._sock

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _call(self, op: bytes, parse, body: bytes = b""):
        t0 = time.perf_counter()
        with self._lock:
            sock = self._ensure_sock()
            try:
                send_frame(sock, op, body)
                status, reply = recv_frame(sock)
            except FrameError as e:
                # desynced reply stream: the connection is unusable
                self._drop_sock()
                raise BackendUnavailable(
                    f"backend {self.host_id}: {e}") from e
            except (OSError, ConnectionError) as e:
                # timeout, reset, refused — a dying or unreachable host;
                # finally-style cleanup so the fd never leaks
                self._drop_sock()
                kind = "timed out" if isinstance(e, TimeoutError) else str(e)
                raise BackendUnavailable(
                    f"backend {self.host_id} {op.decode()!s}: "
                    f"{kind}") from e
            dq = self._rtt.get(op)
            if dq is None:
                dq = self._rtt[op] = deque(maxlen=self.RTT_WINDOW)
            dq.append(time.perf_counter() - t0)
        if status == b"E":
            err = remote_error(self.host_id, reply)
            if isinstance(err, BackendUnavailable):
                with self._lock:
                    self._drop_sock()   # server said fatal: it closed too
            raise err
        if status != b"R":
            with self._lock:
                self._drop_sock()
            raise BackendUnavailable(
                f"backend {self.host_id}: bad reply status {status!r}")
        try:
            return parse(reply)
        except (ValueError, KeyError, struct.error) as e:
            # CodecError included (it is a ValueError): a reply that
            # fails to parse is a corrupt peer, not a caller bug
            raise BackendUnavailable(
                f"backend {self.host_id}: corrupt {op.decode()!s} "
                f"reply: {e}") from e

    def rtt_stats(self) -> dict:
        """Per-op frame round-trip latency over the sliding window:
        ``{op: {count, p50_ms, p95_ms, max_ms}}`` (op is the one-byte
        frame opcode, e.g. "S" submit / "P" poll)."""
        with self._lock:
            windows = {op: list(dq) for op, dq in self._rtt.items()}
        out = {}
        for op, xs in sorted(windows.items()):
            if not xs:
                continue
            xs.sort()
            n = len(xs)
            out[op.decode()] = {
                "count": n,
                "p50_ms": xs[n // 2] * 1e3,
                "p95_ms": xs[min(n - 1, int(math.ceil(0.95 * n)) - 1)] * 1e3,
                "max_ms": xs[-1] * 1e3,
            }
        return out

    def submit(self, req) -> int:
        return self._call(b"S", lambda b: struct.unpack("<q", b)[0],
                          encode_request(req))

    def poll(self) -> list:
        return self._call(b"P", _unpack_results)

    def flush(self) -> list:
        return self._call(b"F", _unpack_results)

    def take_demand(self) -> dict:
        pairs = self._call(b"D", json.loads)
        return {bucket_from_dict(d): v for d, v in pairs}

    def prewarm(self, menu) -> dict:
        body = json.dumps([spec_to_dict(s) for s in menu]).encode()
        return self._call(b"W", json.loads, body)

    def stats(self) -> dict:
        return self._call(b"T", json.loads)

    def compile_count(self) -> int:
        return int(self._call(b"C", json.loads))

    def metrics(self) -> dict:
        _host, snap = self._call(b"M", decode_metrics)
        return snap

    def ping(self) -> bool:
        """Health probe: one ``H`` frame through the serve loop. Raises
        ``BackendUnavailable`` (within the configured timeouts) when the
        host is unreachable, hung, or desynced."""
        return self._call(b"H", lambda b: b) == b"ok"

    def shutdown_server(self) -> None:
        try:
            self._call(b"Q", lambda b: b)
        except (BackendError, RuntimeError, OSError, ConnectionError):
            pass

    def kill_server(self) -> None:
        """Chaos drill: make the remote die abruptly (``X`` op — the
        server closes without replying, like a crash). Fire-and-forget."""
        with self._lock:
            if self._sock is not None:
                try:
                    send_frame(self._sock, b"X")
                except OSError:
                    pass
            self._drop_sock()

    def close(self) -> None:
        with self._lock:
            self._drop_sock()


# -- graceful degradation (DESIGN.md §13) ------------------------------------

class ShedLadder:
    """Overload response as a ladder, cheapest fidelity first.

    The paper's premise is that fidelity is a *schedulable* trade — so
    under sustained overload the frontend should spend rate before it
    spends correctness, and spend correctness (with a quote) before it
    sheds:

      level 0  full fidelity
      level 1  strip extras: ``measure_wire`` accounting off (the rANS
               coding tail is pure observability cost)
      level 2  degrade the schedule: halve the iteration budget (and a
               DP bit budget with it) — SE quotes the predicted final
               MSE at both budgets *before* the cut, so the degradation
               is priced, not silent
      level 3  shed (``Overloaded`` propagates to the caller)

    Escalation: ``up_after`` sheds inside ``window_s`` raise the level;
    a full calm window with no sheds lowers it one step. Deterministic
    under an injected clock (tests drive it synthetically). Off by
    default (``RouterPolicy.shed_ladder``) — degradation changes
    results, so it must be an explicit operator choice."""

    def __init__(self, window_s: float = 2.0, up_after: int = 3,
                 clock=time.monotonic):
        self.window_s = float(window_s)
        self.up_after = max(1, int(up_after))
        self.clock = clock
        self.level = 0
        self._shed_times: deque = deque(maxlen=256)
        self._last_shed = -math.inf
        self._quotes: dict = {}   # SE quote memo per operating point

    def record_shed(self, now: float | None = None) -> int:
        """One Overloaded event; escalates after ``up_after`` in-window
        sheds. Returns the (possibly new) level."""
        now = self.clock() if now is None else now
        self._last_shed = now
        self._shed_times.append(now)
        horizon = now - self.window_s
        while self._shed_times and self._shed_times[0] < horizon:
            self._shed_times.popleft()
        if len(self._shed_times) >= self.up_after and self.level < 3:
            self.level += 1
            self._shed_times.clear()
        return self.level

    def relax(self, now: float | None = None) -> int:
        """Called on clean admissions: one calm ``window_s`` with no
        sheds steps the ladder back down."""
        now = self.clock() if now is None else now
        if self.level > 0 and now - self._last_shed >= self.window_s:
            self.level -= 1
            self._last_shed = now   # each step down needs its own window
        return self.level

    def _quote(self, req, t_deg: int) -> "tuple[float, float]":
        """SE-predicted final MSE at the full and degraded iteration
        budgets (memoized per operating point — the quote must not make
        overload worse)."""
        key = (req.n, req.m, req.snr_db, float(req.prior.eps),
               float(req.prior.mu_s), float(req.prior.sigma_s),
               req.n_iter, t_deg)
        hit = self._quotes.get(key)
        if hit is None:
            prob = req.problem()
            full = float(se_trajectory(prob, req.n_iter)[-1])
            deg = float(se_trajectory(prob, t_deg)[-1])
            hit = self._quotes[key] = (full, deg)
        return hit

    def apply(self, req) -> "tuple[object, dict | None]":
        """Degrade one request per the current level. Returns the
        (possibly replaced) request and a quote dict (None at level 0 /
        nothing to strip). Level 3 does not mutate — the shed itself
        happens at admission."""
        if self.level <= 0:
            return req, None
        changed: dict = {}
        if req.measure_wire:
            changed["measure_wire"] = False
        if self.level >= 2 and req.n_iter > 2:
            t_deg = max(2, (req.n_iter + 1) // 2)
            full, deg = self._quote(req, t_deg)
            changed["n_iter"] = t_deg
            if req.deltas is not None:
                changed["deltas"] = req.deltas[:t_deg]
            if req.policy == "dp" and req.dp_total_bits:
                changed["dp_total_bits"] = max(
                    1, math.ceil(req.dp_total_bits / 2))
            quote = {"level": self.level, "n_iter_full": req.n_iter,
                     "n_iter": t_deg, "mse_full": full, "mse_degraded": deg,
                     "mse_ratio": deg / max(full, 1e-300)}
        elif changed:
            quote = {"level": self.level, "stripped": sorted(changed)}
        else:
            return req, None
        return dataclasses.replace(req, **changed), quote


@dataclasses.dataclass
class _Flight:
    """Frontend-side ownership record of one routed request — everything
    needed to re-admit it bit-identically if its host dies."""

    gid: int                      # global request id (stable across retries)
    cost: float                   # routed shape cost (returned on complete)
    req: object                   # caller's template, for replay
    key: object                   # routing key
    t_submit: float               # monotonic submit time (latency/hedging)
    attempts: int = 0             # re-admissions so far
    t_detect: float | None = None  # failure-detection time (recovery clock)
    hedged: bool = False          # a duplicate copy is (or was) in flight


# -- the cluster service ----------------------------------------------------

class ClusterService:
    """Multi-host elastic serving plane: ``SolveService`` semantics
    (submit/solve/stream/flush) over a set of host backends, with
    load × shape routing and per-bucket replica autoscaling.

    ``backends=None`` builds ``n_hosts`` in-process emulated hosts, each
    its own ``SolveService`` (shared ``BucketPolicy`` — routing keys must
    agree structurally with every backend's bucketing; heterogeneous
    policies across hosts would route a request to a bucket the backend
    then shapes differently). Row and column buckets ride the same
    router: the routing key carries the layout axis, so tall C-MP-AMP
    requests and wide row requests each scale their own replicas.

    Routing is batch-affine: a bucket's filling partial batch stays on
    one host (the ``_fill`` hint to ``ClusterRouter.route``), so
    cross-host routing happens at batch granularity — every dispatch
    runs at the width the single-host service would have used, which is
    what makes cluster results bit-identical to it, and load balancing
    happens between batches, not inside them.

    Autoscaling is scrape-driven: ``scrape()`` drains every backend's
    demand window into the autoscaler and applies its events (scale-up
    prewarms the bucket's exemplar spec on the new host before traffic
    lands there). With ``RouterPolicy.scrape_every_s > 0`` submits
    trigger scrapes automatically; the default is manual (deterministic
    for tests and benches).

    ``n_hosts`` in-process services run on ``service_kwargs["device"]``,
    the card unless the caller asks for the CPU (as the tests do); several
    on one card share it, which measures oversubscription, not scaling.
    """

    def __init__(self, backends: list | None = None, n_hosts: int = 1,
                 policy: BucketPolicy | None = None,
                 router_policy: RouterPolicy | None = None,
                 service_factory=None, **service_kwargs):
        self.policy = policy or BucketPolicy()
        if backends is None:
            factory = service_factory or (
                lambda i: SolveService(policy=self.policy,
                                       **service_kwargs))
            backends = [LocalBackend(f"host{i}", factory(i))
                        for i in range(max(1, n_hosts))]
        self.backends = {b.host_id: b for b in backends}
        assert len(self.backends) == len(backends), "duplicate host ids"
        self.router_policy = router_policy or RouterPolicy()
        self.router = ClusterRouter(
            [HostInfo(b.host_id, b.n_devices) for b in backends],
            self.router_policy)
        self.autoscaler = Autoscaler(self.router, self.router_policy)
        self._next_id = 0
        # (host_id, backend-local id) -> _Flight: the frontend OWNS every
        # admitted request until its result is delivered — ownership is
        # what makes failover possible (DESIGN.md §13)
        self._inflight: dict = {}
        self._completed: list = []
        # fault tolerance (DESIGN.md §13)
        self._fail_counts: dict = {}   # host -> consecutive conn failures
        self._fail_events: dict = {}   # host -> cumulative conn failures
        self._revived: set = set()     # hosts ever declared dead (stale-
        #                                result tolerance in _absorb)
        self._zombies: dict = {}       # (host, local) -> cost: losing
        #                                hedge copies, completed on arrival
        self._gid_refs: dict = {}      # gid -> {(host, local)} hedge copies
        self._lat: dict = {}           # routing key -> completion latencies
        self._recovery_s: list = []    # detect -> replayed-result latency
        self._lost_gids: set = set()
        self.retries = 0               # re-admissions (submit + failover)
        self.failovers = 0             # hosts declared dead
        self.hedges = 0
        self.lost = 0                  # admitted but never completed
        self.degraded = 0              # requests the shed ladder touched
        self.shed_quotes: list = []    # SE quotes for degraded requests
        self._specs: dict = {}      # routing key -> exemplar PrewarmSpec
        # (host_id, routing key) -> open-partial-batch depth, counted
        # mod max_batch (a group dispatches exactly when it fills): the
        # batch-affinity hint for the router, reset when flush closes
        # every open group
        self._fill: dict = {}
        self._last_scrape = time.monotonic()
        self.shed_count = 0
        self.submitted = 0
        # telemetry (DESIGN.md §12): mirrors the backends' flag so a
        # telemetry-off cluster carries zero span/metric overhead; the
        # frontend registry holds the router/admission/TCP-RTT series and
        # merges with per-host snapshots in ``metrics()``
        self.telemetry = bool(service_kwargs.get("telemetry", True))
        self._registry = None
        if self.telemetry:
            self._registry = MetricsRegistry()
            self._registry.collect(self._collect_frontend)
        # autoscaler scrape loop (daemon thread, ``start_scraper``)
        self._scrape_thread: threading.Thread | None = None
        self._scrape_stop: threading.Event | None = None
        self.scrape_errors: list = []
        # graceful degradation ladder (opt-in: degradation changes
        # results, so it must be an explicit operator choice)
        self._ladder = (ShedLadder()
                        if self.router_policy.shed_ladder else None)

    # -- intake --------------------------------------------------------------

    def _routing_key(self, req):
        return routing_key(req, self.policy)

    def _open_batch_host(self, key) -> str | None:
        """The replica holding this bucket's fullest open partial batch
        (None when every group is empty or just dispatched): routing
        there first keeps one filling batch on one host — continuous
        batching across hosts would otherwise shear groups apart as
        completions drain the load signal mid-stream."""
        best_fill, best = 0, None
        for hid in self.router.replicas(key):
            f = self._fill.get((hid, key), 0)
            if f > best_fill:
                best_fill, best = f, hid
        return best

    def _bump_fill(self, host_id: str, key) -> None:
        f = (self._fill.get((host_id, key), 0) + 1) % self.policy.max_batch
        self._fill[(host_id, key)] = f

    def _remember_spec(self, key, req) -> None:
        if key not in self._specs:
            self._specs[key] = PrewarmSpec(
                n=req.n, m=req.m, n_proc=req.n_proc, n_iter=req.n_iter,
                policy=req.policy, transport=req.transport,
                layout=req.layout, snr_db=req.snr_db, prior=req.prior)

    def _unbump_fill(self, host_id: str, key) -> None:
        """Exact inverse of ``_bump_fill`` (mod ``max_batch``) — a submit
        the backend never accepted opened no group slot."""
        f = self._fill.get((host_id, key))
        if f is not None:
            self._fill[(host_id, key)] = (f - 1) % self.policy.max_batch

    def _place(self, req, key, cost, t_admit: float, *, gid=None,
               attempts: int = 0, t_detect=None, retry: bool = False):
        """Route + forward one request, retrying across hosts on
        connection-level failure (``BackendUnavailable``): the failed
        host is charged a failure (walking healthy -> suspect -> dead),
        its routed cost and fill slot are returned, and after a linear
        backoff the request routes again with that host excluded.
        ``RemoteRequestError`` (the request's own fault) propagates
        without retry — replaying a bad request elsewhere just fails
        elsewhere. Returns the global id (allocated on first successful
        placement so shed/failed submits leave no gid gap)."""
        rp = self.router_policy
        avoid: set = set()
        tries = 0
        while True:
            t_route = _tnow() if self.telemetry else 0.0
            host_id = self.router.route(key, cost,
                                        prefer=self._open_batch_host(key),
                                        avoid=frozenset(avoid))
            self._bump_fill(host_id, key)
            # the backend assigns its own local id: hand it a fresh copy
            # so the caller's template (replayed verbatim on failover)
            # and our global numbering stay untouched
            fwd = dataclasses.replace(req, request_id=-1)
            if self.telemetry:
                # frontend spans travel WITH the request (codec header)
                # and come back on the result; the backend appends its
                # own with host=None, which ``_absorb`` tags with the
                # routed host. Replays carry a "retry" span; the span
                # list must still END with "route" (the service keys its
                # handoff stamp on it).
                base = list(req.spans or [])
                if retry or tries > 0:
                    base.append(_tspan("retry", t_admit, t_route,
                                       host="frontend"))
                fwd.spans = base + [
                    _tspan("admit", t_admit, t_route, host="frontend"),
                    _tspan("route", t_route, host="frontend")]
            try:
                local = self.backends[host_id].submit(fwd)
            except RemoteRequestError:
                self._unbump_fill(host_id, key)
                self.router.complete(host_id, cost)
                raise
            except BackendUnavailable as e:
                self._unbump_fill(host_id, key)
                self.router.complete(host_id, cost)
                self._note_failure(host_id, e)
                avoid.add(host_id)
                tries += 1
                self.retries += 1
                if tries > max(0, rp.retry_limit):
                    raise BackendUnavailable(
                        f"submit failed on {tries} host(s): {e}") from e
                if rp.retry_backoff_s > 0:
                    time.sleep(rp.retry_backoff_s * tries)
                continue
            self._note_ok(host_id)
            if gid is None:
                gid = self._next_id
                self._next_id += 1
            self._inflight[(host_id, local)] = _Flight(
                gid=gid, cost=cost, req=req, key=key,
                t_submit=time.monotonic(), attempts=attempts,
                t_detect=t_detect)
            return gid

    def submit(self, req) -> int:
        """Route one request to a backend host; returns its *global*
        request id (backend-local ids never escape). Raises
        ``Overloaded`` when every live replica of the request's bucket
        is at the admission cap — the shed path; ``shed_count`` tracks
        it (and escalates the shed ladder when one is enabled). A host
        that fails the submit is retried around (``_place``)."""
        t_admit = _tnow() if self.telemetry else 0.0
        quote = None
        if self._ladder is not None:
            req, quote = self._ladder.apply(req)
        key = self._routing_key(req)
        cost = shape_cost(key)
        self._remember_spec(key, req)
        try:
            gid = self._place(req, key, cost, t_admit)
        except Overloaded:
            self.shed_count += 1
            if self._ladder is not None:
                self._ladder.record_shed()
            raise
        if quote is not None:
            self.degraded += 1
            self.shed_quotes.append(quote)
        elif self._ladder is not None:
            self._ladder.relax()
        self.submitted += 1
        if (self.router_policy.scrape_every_s > 0.0
                and self._scrape_thread is None):
            # piggyback scraping only when no daemon scraper owns the tick
            now = time.monotonic()
            if now - self._last_scrape >= self.router_policy.scrape_every_s:
                self.check_health()
                self.scrape(now)
        return gid

    # -- failure detection & recovery (DESIGN.md §13) ------------------------

    def _note_ok(self, host_id: str) -> None:
        """A successful call resets the consecutive-failure count and
        heals a suspect host (dead hosts revive only via
        ``check_health`` — one good frame is not proof of life)."""
        if self._fail_counts.get(host_id):
            self._fail_counts[host_id] = 0
        if self.router.host_state(host_id) == "suspect":
            self.router.mark_healthy(host_id)

    def _note_failure(self, host_id: str, exc) -> str:
        """Charge one connection-level failure and walk the host state
        machine: ``suspect_after`` consecutive failures lose routing
        ties, ``dead_after`` evict the host and fail its in-flight
        requests over. Per-request errors never land here — they say
        nothing about the host. Returns the resulting state."""
        n = self._fail_counts.get(host_id, 0) + 1
        self._fail_counts[host_id] = n
        self._fail_events[host_id] = self._fail_events.get(host_id, 0) + 1
        rp = self.router_policy
        state = self.router.host_state(host_id)
        if state == "dead":
            return state
        if n >= max(1, rp.dead_after):
            self._declare_dead(host_id)
            return "dead"
        if n >= max(1, rp.suspect_after):
            self.router.mark_suspect(host_id)
            return "suspect"
        return state

    def _declare_dead(self, host_id: str) -> None:
        """Evict a host and recover its work: the router drops it from
        every replica set and zeroes its outstanding cost; its stranded
        flights re-admit on survivors in original admission order — so
        full groups re-form at the same padded widths and the replayed
        results are bit-identical to the originals."""
        t_detect = time.monotonic()
        t_pc = _tnow() if self.telemetry else 0.0
        self.router.mark_dead(host_id)
        self.failovers += 1
        self._revived.add(host_id)
        b = self.backends.get(host_id)
        if b is not None:
            try:
                b.close()   # drop the dead socket; revival reconnects
            except Exception:  # noqa: BLE001 — already dead
                pass
        # losing hedge copies on the dead host will never arrive
        for hk in [k for k in self._zombies if k[0] == host_id]:
            del self._zombies[hk]
        # its open partial batches are gone with it
        for fk in [k for k in self._fill if k[0] == host_id]:
            del self._fill[fk]
        stranded = sorted(
            ((hk, fl) for hk, fl in self._inflight.items()
             if hk[0] == host_id),
            key=lambda kv: kv[1].gid)
        for hk, fl in stranded:
            del self._inflight[hk]
            refs = self._gid_refs.get(fl.gid)
            if refs is not None:
                refs.discard(hk)
                if refs:
                    continue        # a hedged copy survives elsewhere
                del self._gid_refs[fl.gid]
            self._readmit(fl, t_detect, t_pc)

    def _readmit(self, fl: _Flight, t_detect: float, t_pc: float) -> None:
        """Replay one stranded flight on a surviving host (same gid,
        same request template -> same bucket program -> same bits);
        past the retry limit, or with nowhere live to go, it is lost —
        counted, never silently dropped."""
        rp = self.router_policy
        if fl.attempts >= max(0, rp.retry_limit):
            self.lost += 1
            self._lost_gids.add(fl.gid)
            return
        self.retries += 1
        try:
            self._place(fl.req, fl.key, fl.cost, t_pc, gid=fl.gid,
                        attempts=fl.attempts + 1, t_detect=t_detect,
                        retry=True)
        except (Overloaded, BackendError):
            self.lost += 1
            self._lost_gids.add(fl.gid)

    def check_health(self) -> dict:
        """Probe every backend once (the ``H`` health frame / local
        no-op). Successes reset failure counts, heal suspects, and
        revive dead hosts; failures walk the state machine — so a dead
        peer is detected within ``dead_after`` probe intervals even
        with no traffic in flight. The scraper daemon drives this every
        tick; tests and ``amp_serve`` call it directly. Returns
        ``{host_id: state}``."""
        for host_id, b in list(self.backends.items()):
            try:
                ok = b.ping()
            except BackendError as e:
                self._note_failure(host_id, e)
                continue
            except Exception as e:  # noqa: BLE001 — a broken backend
                self._note_failure(host_id, BackendUnavailable(repr(e)))
                continue
            if not ok:
                self._note_failure(
                    host_id, BackendUnavailable("bad health reply"))
                continue
            if self.router.host_state(host_id) == "dead":
                self.router.mark_healthy(host_id)   # revival
            self._fail_counts[host_id] = 0
            self._note_ok(host_id)
        return self.router.host_states()

    def _hedge_tail(self) -> None:
        """Tail-latency hedging (``RouterPolicy.hedge_p99_mult`` > 0):
        an in-flight request stuck past mult x its bucket's p99
        completion latency is duplicated onto a different live host;
        the first copy to finish wins and the loser is dropped on
        arrival (``_zombies``). Targets slow/suspect hosts without
        waiting for the dead threshold. Off by default: the winning
        copy may have batched at a different width, so hedging trades
        strict determinism for tail latency."""
        mult = self.router_policy.hedge_p99_mult
        if mult <= 0.0:
            return
        now = time.monotonic()
        for hk, fl in list(self._inflight.items()):
            if fl.hedged or fl.gid in self._gid_refs:
                continue
            dq = self._lat.get(fl.key)
            if not dq or len(dq) < 8:
                continue            # no latency signal yet
            xs = sorted(dq)
            p99 = xs[min(len(xs) - 1, math.ceil(0.99 * len(xs)) - 1)]
            if now - fl.t_submit < mult * p99:
                continue
            host_id = hk[0]
            try:
                other = self.router.route(fl.key, fl.cost,
                                          avoid=frozenset({host_id}))
            except Overloaded:
                continue            # nowhere to hedge to
            fwd = dataclasses.replace(fl.req, request_id=-1)
            if self.telemetry:
                t_route = _tnow()
                fwd.spans = list(fl.req.spans or []) + [
                    _tspan("retry", t_route, t_route, host="frontend"),
                    _tspan("admit", t_route, t_route, host="frontend"),
                    _tspan("route", t_route, host="frontend")]
            try:
                local = self.backends[other].submit(fwd)
            except BackendError as e:
                self.router.complete(other, fl.cost)
                if isinstance(e, BackendUnavailable):
                    self._note_failure(other, e)
                continue
            fl.hedged = True
            dup = _Flight(gid=fl.gid, cost=fl.cost, req=fl.req,
                          key=fl.key, t_submit=now,
                          attempts=fl.attempts + 1,
                          t_detect=fl.t_detect, hedged=True)
            self._inflight[(other, local)] = dup
            self._gid_refs[fl.gid] = {hk, (other, local)}
            self.hedges += 1

    def _absorb(self, host_id: str, results) -> None:
        """Rewrite backend-local ids to global ids, return the routed
        cost to the router, buffer globally. Hedge-aware: the first copy
        of a hedged gid wins and its siblings become zombies (completed
        for cost accounting, dropped on arrival); a host that was
        declared dead may deliver results for flights already failed
        over — those are dropped (their cost was zeroed at eviction)."""
        now = time.monotonic()
        for res in results:
            hk = (host_id, res.request_id)
            zcost = self._zombies.pop(hk, None)
            if zcost is not None:
                # late duplicate of an already-delivered hedged request
                self.router.complete(host_id, zcost)
                continue
            fl = self._inflight.pop(hk, None)
            if fl is None:
                assert host_id in self._revived, \
                    f"backend {host_id} returned unknown id {res.request_id}"
                continue
            refs = self._gid_refs.pop(fl.gid, None)
            if refs is not None:
                for other in refs:
                    if other == hk:
                        continue
                    dup = self._inflight.pop(other, None)
                    if dup is not None:
                        self._zombies[other] = dup.cost
            self.router.complete(host_id, fl.cost)
            dq = self._lat.get(fl.key)
            if dq is None:
                dq = self._lat[fl.key] = deque(maxlen=512)
            dq.append(now - fl.t_submit)
            if fl.t_detect is not None:
                # recovery latency: failure detected -> replayed result
                rec = now - fl.t_detect
                self._recovery_s.append(rec)
                if self._registry is not None:
                    self._registry.histogram(
                        "amp_recovery_seconds",
                        "Failure detected -> re-admitted request completed",
                        buckets=RECOVERY_BUCKETS).observe(rec)
            spans = (tag_host(res.spans, host_id)
                     if self.telemetry and res.spans else res.spans)
            self._completed.append(
                dataclasses.replace(res, request_id=fl.gid, spans=spans))

    def _poll_all(self) -> None:
        """Poll every live backend into ``_completed``; a backend whose
        connection fails is charged (and possibly declared dead, failing
        its flights over) instead of killing the whole poll."""
        for host_id, b in list(self.backends.items()):
            if self.router.host_state(host_id) == "dead":
                continue
            try:
                self._absorb(host_id, b.poll())
            except BackendUnavailable as e:
                self._note_failure(host_id, e)

    def _flush_all(self) -> None:
        """Flush every live backend, re-flushing survivors after any
        failover: a mid-flush death re-admits its stranded flights into
        open groups on live hosts, which then need their own flush. The
        round bound covers the worst case of every host taking
        ``dead_after`` failures to die, one per round."""
        rp = self.router_policy
        max_rounds = 2 + max(1, rp.dead_after) * max(1, len(self.backends))
        for _ in range(max_rounds):
            clean = True
            for host_id, b in list(self.backends.items()):
                if self.router.host_state(host_id) == "dead":
                    continue
                try:
                    self._absorb(host_id, b.flush())
                except BackendUnavailable as e:
                    self._note_failure(host_id, e)
                    clean = False
            live_pending = any(
                self.router.host_state(hk[0]) != "dead"
                for hk in self._inflight)
            if clean and not live_pending:
                return

    def poll(self) -> list:
        """Collect materialized results from every live backend (no
        forced dispatch of partial batches)."""
        self._hedge_tail()
        self._poll_all()
        out, self._completed = self._completed, []
        return out

    def flush(self) -> list:
        """Dispatch every backend's stragglers; return all buffered
        results. Survives backend deaths mid-flush (their in-flight
        requests replay on live hosts and flush again)."""
        self._hedge_tail()
        self._flush_all()
        self._fill.clear()          # flush closed every open group
        out, self._completed = self._completed, []
        return out

    def solve(self, reqs) -> list:
        """Submit + flush; results in submission order (``SolveService``
        semantics: foreign buffered results stay for their consumer).
        Raises ``BackendUnavailable`` if any admitted request was lost —
        a partial answer must never look like a complete one."""
        ids = [self.submit(r) for r in reqs]
        own = set(ids)
        by_id = {}
        for r in self.flush():
            if r.request_id in own:
                by_id[r.request_id] = r
            else:
                self._completed.append(r)
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise BackendUnavailable(
                f"{len(missing)} request(s) lost after retries: "
                f"gids {missing[:8]}")
        return [by_id[i] for i in ids]

    def stream(self, reqs):
        """Continuous batching across hosts: each submit polls every
        live backend, so a bucket batch completing on any host yields
        immediately; stragglers flush when the input ends. Lost
        requests (host death past the retry limit) simply never yield —
        callers needing all-or-nothing use ``solve``."""
        own = set()

        def take_own():
            keep = []
            for r in self._completed:
                if r.request_id in own:
                    yield r
                else:
                    keep.append(r)
            self._completed = keep

        for r in reqs:
            own.add(self.submit(r))
            self._hedge_tail()
            self._poll_all()
            if self._completed:
                yield from take_own()
        self._flush_all()
        self._fill.clear()
        yield from take_own()

    def partition(self, reqs) -> dict:
        """Route a request list without executing it: ``{host_id:
        [requests]}`` in routed order. The weak-scaling bench uses this
        to time each emulated host's share in isolation. Routed costs
        stay outstanding until the whole list is placed — completing
        each immediately would zero the load signal between requests
        and funnel every tie to the first host — then all return to the
        router. Planning only: batch-affinity fill and the router's
        served counters are restored afterwards, so repeated partitions
        (the bench times warm passes) leave no trace in ``stats()``.
        Runs under the router lock end-to-end: the save/route/restore
        sequence must be atomic against a concurrent scraper thread or
        another submitting thread, or the restored counters would erase
        their updates."""
        shares: dict = {hid: [] for hid in self.backends}
        placed = []
        with self.router.lock:
            saved_fill = dict(self._fill)  # planning only: no group opens
            saved_served = dict(self.router._served)
            saved_cost = dict(self.router._served_cost)
            for req in reqs:
                key = self._routing_key(req)
                cost = shape_cost(key)
                self._remember_spec(key, req)
                host_id = self.router.route(
                    key, cost, prefer=self._open_batch_host(key))
                self._bump_fill(host_id, key)
                placed.append((host_id, cost))
                shares[host_id].append(req)
            for host_id, cost in placed:
                self.router.complete(host_id, cost)
            self._fill = saved_fill
            self.router._served = saved_served
            self.router._served_cost = saved_cost
        return shares

    # -- elasticity ----------------------------------------------------------

    def scrape(self, now: float | None = None) -> list:
        """One autoscaler tick: drain every backend's demand window,
        fold it into the EWMAs, apply the scaling events (scale-up
        prewarms the bucket's exemplar spec on the new host). Returns
        the applied events."""
        now = time.monotonic() if now is None else now
        self._last_scrape = now
        deltas: dict = {}
        for host_id, b in list(self.backends.items()):
            if self.router.host_state(host_id) == "dead":
                continue
            try:
                dem = b.take_demand()
            except BackendUnavailable as e:
                self._note_failure(host_id, e)
                continue
            for k, v in dem.items():
                rk = dataclasses.replace(k, placement="local")
                deltas[rk] = deltas.get(rk, 0) + v
        self.autoscaler.observe(deltas, now)
        events = self.autoscaler.step(now)
        for kind, key, host_id in events:
            if kind != "scale_up":
                continue
            spec = self._specs.get(key)
            if spec is not None:
                try:
                    self.backends[host_id].prewarm([spec])
                except BackendUnavailable as e:
                    self._note_failure(host_id, e)
                    continue
                self.router.mark_warm(host_id, key)
        return events

    def start_scraper(self, interval_s: float | None = None) \
            -> threading.Thread:
        """Run the autoscaler scrape loop on a daemon thread at a real
        interval (the production shape — ``amp_serve`` uses this instead
        of piggybacking scrapes on submits). Idempotent; ``stop_scraper``
        or ``close`` shuts it down cleanly (the thread exits within one
        interval). Scrape exceptions are recorded on ``scrape_errors``
        and the loop keeps going — a transient backend hiccup must not
        kill autoscaling."""
        if self._scrape_thread is not None and self._scrape_thread.is_alive():
            return self._scrape_thread
        interval = (interval_s if interval_s is not None
                    else self.router_policy.scrape_every_s) or 1.0
        stop = self._scrape_stop = threading.Event()

        def loop() -> None:
            while not stop.wait(interval):
                try:
                    self.check_health()   # the heartbeat rides the tick
                    self.scrape()
                except Exception as e:  # noqa: BLE001 — keep scraping
                    self.scrape_errors.append(repr(e))

        th = threading.Thread(target=loop, name="cluster-scraper",
                              daemon=True)
        self._scrape_thread = th
        th.start()
        return th

    def stop_scraper(self, timeout: float = 5.0) -> None:
        """Signal the scrape loop to exit and join it."""
        if self._scrape_stop is not None:
            self._scrape_stop.set()
        th = self._scrape_thread
        if th is not None and th.is_alive():
            th.join(timeout)
        self._scrape_thread = None

    def prewarm(self, menu, hosts: list | None = None) -> dict:
        """Prewarm a traffic menu on every backend (or a named subset)
        and mark the (host, bucket) pairs warm for the router.
        ``PrewarmSpec`` carries the same structural fields as a request,
        so ``routing_key`` applies to it directly."""
        menu = list(menu)
        targets = hosts if hosts is not None else list(self.backends)
        reports = {}
        for host_id in targets:
            reports[host_id] = self.backends[host_id].prewarm(menu)
            for spec in menu:
                key = routing_key(spec, self.policy)
                self._specs.setdefault(key, spec)
                self.router.mark_warm(host_id, key)
        return reports

    # -- observability -------------------------------------------------------

    def compile_count(self) -> int:
        n = 0
        for hid, b in self.backends.items():
            if self.router.host_state(hid) == "dead":
                continue
            try:
                n += b.compile_count()
            except BackendError:
                pass
        return n

    def recovery_stats(self) -> dict:
        """Failover recovery latency (failure detected -> replayed
        result delivered), in ms. Empty dict when nothing failed over."""
        xs = sorted(self._recovery_s)
        if not xs:
            return {}

        def pct(q: float) -> float:
            return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)]

        return {
            "count": len(xs),
            "p50_ms": 1e3 * pct(0.50),
            "p95_ms": 1e3 * pct(0.95),
            "max_ms": 1e3 * xs[-1],
        }

    def stats(self) -> dict:
        out = {
            "submitted": self.submitted,
            "shed": self.shed_count,
            "inflight": len(self._inflight),
            "retries": self.retries,
            "failovers": self.failovers,
            "hedges": self.hedges,
            "lost": self.lost,
            "degraded": self.degraded,
            "host_states": self.router.host_states(),
            "recovery": self.recovery_stats(),
            "router": self.router.stats(),
            "autoscaler": self.autoscaler.stats(),
            "hosts": {},
        }
        for hid, b in self.backends.items():
            if self.router.host_state(hid) == "dead":
                out["hosts"][hid] = {"state": "dead"}
                continue
            try:
                out["hosts"][hid] = b.stats()
            except BackendError:
                out["hosts"][hid] = {"state": self.router.host_state(hid)}
        if self._ladder is not None:
            out["shed_ladder_level"] = self._ladder.level
        return out

    def rtt_stats(self) -> dict:
        """Per-host TCP frame round-trip stats (``TcpBackend.rtt_stats``;
        empty for in-process backends — there is no wire to time)."""
        return {hid: b.rtt_stats() for hid, b in self.backends.items()
                if hasattr(b, "rtt_stats")}

    def _collect_frontend(self, reg: MetricsRegistry) -> None:
        """Frontend-plane collector: admission counters, router load,
        autoscaler events, and TCP frame RTTs — all pulled at snapshot
        time from state that already has its own locks."""
        reg.counter("amp_cluster_submitted_total",
                    "Requests admitted by the frontend").set_total(
                        self.submitted)
        reg.counter("amp_cluster_shed_total",
                    "Requests shed at the admission cap").set_total(
                        self.shed_count)
        reg.gauge("amp_cluster_inflight",
                  "Requests routed but not yet completed").set(
                      len(self._inflight))
        rs = self.router.stats()
        out_g = reg.gauge("amp_router_outstanding_cost",
                          "Outstanding cost-weighted work", ("host",))
        srv_c = reg.counter("amp_router_served_total",
                            "Requests routed per host", ("host",))
        for hid, v in rs["outstanding"].items():
            out_g.set(v, host=hid)
        for hid, v in rs["served"].items():
            srv_c.set_total(v, host=hid)
        imb = rs["imbalance"]
        reg.gauge("amp_router_imbalance",
                  "Cost-weighted served-share max/min").set(
                      imb if math.isfinite(imb) else -1.0)
        # fault-tolerance plane (DESIGN.md §13)
        reg.counter("amp_failover_total",
                    "Hosts declared dead (in-flight failed over)"
                    ).set_total(self.failovers)
        reg.counter("amp_retry_total",
                    "Request re-admissions (submit retries + failover "
                    "replays)").set_total(self.retries)
        reg.counter("amp_hedge_total",
                    "Hedged duplicate submissions").set_total(self.hedges)
        reg.counter("amp_lost_requests_total",
                    "Admitted requests lost after retries (must stay 0)"
                    ).set_total(self.lost)
        reg.counter("amp_degraded_total",
                    "Requests degraded by the shed ladder"
                    ).set_total(self.degraded)
        hb = reg.counter("amp_heartbeat_failures_total",
                         "Connection-level failures per host", ("host",))
        for hid, n in self._fail_events.items():
            hb.set_total(n, host=hid)
        stg = reg.gauge(
            "amp_host_state",
            "Host state index into (healthy, suspect, dead, draining)",
            ("host",))
        for hid, st in self.router.host_states().items():
            stg.set(HOST_STATES.index(st), host=hid)
        if self._ladder is not None:
            reg.gauge("amp_shed_ladder_level",
                      "Graceful-degradation ladder level (0-3)"
                      ).set(self._ladder.level)
        events = self.autoscaler.stats()["events"]
        ev_c = reg.counter("amp_autoscaler_events_total",
                           "Applied scaling events", ("kind",))
        for kind in ("scale_up", "scale_down"):
            ev_c.set_total(sum(1 for e in events if e[0] == kind),
                           kind=kind)
        for hid, per_op in self.rtt_stats().items():
            cnt = reg.counter("amp_tcp_frames_total",
                              "TCP frames in the RTT window",
                              ("host", "op"))
            p50 = reg.gauge("amp_tcp_rtt_p50_seconds",
                            "Frame round-trip p50", ("host", "op"))
            p95 = reg.gauge("amp_tcp_rtt_p95_seconds",
                            "Frame round-trip p95", ("host", "op"))
            for op, s in per_op.items():
                cnt.set_total(s["count"], host=hid, op=op)
                p50.set(s["p50_ms"] / 1e3, host=hid, op=op)
                p95.set(s["p95_ms"] / 1e3, host=hid, op=op)

    def metrics(self) -> dict:
        """Cluster-wide metrics: every backend's snapshot (fetched over
        the codec's metrics frame for TCP backends) merged with the
        frontend's own registry, one ``host`` label per series
        (DESIGN.md §12)."""
        if self._registry is None:
            return {"metrics": []}
        snaps = [("frontend", self._registry.snapshot())]
        for hid, b in self.backends.items():
            if self.router.host_state(hid) == "dead":
                continue
            try:
                snap = b.metrics()
            except BackendError:
                continue    # a dying host must not break the scrape
            if snap.get("metrics"):
                snaps.append((hid, snap))
        return merge_snapshots(snaps)

    def metrics_text(self) -> str:
        """``metrics()`` rendered as Prometheus text exposition format."""
        return prometheus_text(self.metrics())

    def close(self, shutdown_remote: bool = False) -> None:
        """Stop the scraper (a bounded join) and close every backend;
        ``shutdown_remote`` also asks each ``BackendServer`` to stop."""
        self.stop_scraper()
        for b in self.backends.values():
            if shutdown_remote and isinstance(b, TcpBackend):
                b.shutdown_server()
            b.close()
