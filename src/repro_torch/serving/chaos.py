"""Deterministic chaos harness for the cluster plane (the port of the JAX
package's ``repro.serving.chaos``, which is plain Python and is kept as it
is; its DESIGN.md §13 describes the fault model).

Fault tolerance that is only exercised by real outages is untested
code. This module injects failures *deterministically* — a seeded
``FaultPlan`` decides in advance which backend call dies, errors,
freezes, or slows — so the chaos gate in the test suite and
``bench_serve --chaos`` is reproducible: the same seed kills the same
host at the same call every run, and the recovery path (detection ->
eviction -> bit-identical replay) can be asserted, not eyeballed.

Two injection points, matching the two places reality fails:

* ``ChaosBackend`` wraps any backend object (``LocalBackend`` or
  ``TcpBackend``) and fires faults at the *call* boundary — the shape
  the frontend actually sees (``BackendUnavailable`` on a dead or
  frozen host, ``RemoteRequestError`` on a transient server-side
  error). This is the in-process harness: exact call-indexed timing,
  so a kill can be placed mid-batch with requests provably stranded.

* ``ChaosProxy`` sits on the real TCP path between a ``TcpBackend``
  and a ``BackendServer`` and corrupts the *byte stream* — stalling
  (client blocks until its recv timeout), severing (connection reset),
  or truncating mid-frame. This exercises the wire-level hardening
  (socket timeouts, ``FrameError`` on desync) that call-level wrapping
  cannot reach.

Fault kinds (``FaultSpec.kind``):

    kill     the host is dead from ``at_call`` on: every later call
             raises ``BackendUnavailable`` (permanent)
    error    one transient server-side failure: ``RemoteRequestError``
             at ``at_call`` only (the host itself is fine)
    freeze   the call hangs ``duration_s`` then fails like a timeout
             (``BackendUnavailable``); later calls proceed normally
    delay    the call is slowed by ``duration_s`` then proceeds

``at_call`` counts the wrapped backend's guarded calls from 1, across
all operations (or only those in ``ops`` when given), which is what
makes "kill host1 on its 3rd submit" expressible.
"""
from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time
from typing import Optional, Sequence

from .wire import BackendUnavailable, RemoteRequestError

__all__ = ["FaultSpec", "FaultPlan", "ChaosBackend", "ChaosProxy"]

_KINDS = ("kill", "error", "freeze", "delay")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires at the ``at_call``-th guarded
    call (1-based), optionally restricted to operations named in
    ``ops`` (method names: "submit", "poll", "flush", "ping", ...)."""

    kind: str
    at_call: int
    duration_s: float = 0.0
    ops: Optional[tuple] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at_call < 1:
            raise ValueError("at_call counts from 1")

    def matches(self, op: str, call_no: int) -> bool:
        if self.ops is not None and op not in self.ops:
            return False
        return call_no == self.at_call


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable schedule of faults. Equality of (seed,
    faults) is equality of behaviour — the plan is the whole experiment
    description, so benches record it next to their results."""

    seed: int = 0
    faults: tuple = ()

    @classmethod
    def kill_at(cls, at_call: int, *, ops: Sequence[str] | None = None,
                seed: int = 0) -> "FaultPlan":
        """The chaos-gate plan: one permanent kill at ``at_call``."""
        return cls(seed=seed, faults=(
            FaultSpec("kill", at_call,
                      ops=tuple(ops) if ops is not None else None),))

    @classmethod
    def random(cls, seed: int, n_faults: int = 3, horizon: int = 50,
               kinds: Sequence[str] = ("error", "freeze", "delay"),
               max_duration_s: float = 0.05) -> "FaultPlan":
        """``n_faults`` transient faults at distinct calls in
        [2, horizon], drawn from ``random.Random(seed)`` — same seed,
        same storm. Permanent kills are excluded by default so a random
        storm stresses retries without guaranteeing a failover."""
        rng = random.Random(seed)
        lo, hi = 2, max(2, horizon)
        calls = rng.sample(range(lo, hi + 1),
                           k=min(n_faults, hi - lo + 1))
        faults = tuple(
            FaultSpec(rng.choice(tuple(kinds)), at,
                      duration_s=rng.uniform(0.0, max_duration_s))
            for at in sorted(calls))
        return cls(seed=seed, faults=faults)

    def fault_for(self, op: str, call_no: int) -> Optional[FaultSpec]:
        for f in self.faults:
            if f.matches(op, call_no):
                return f
        return None


class ChaosBackend:
    """Wrap a backend so a ``FaultPlan`` fires at its call boundary.

    Delegates the full backend protocol; ``host_id`` / ``n_devices``
    pass through, so the frontend cannot tell it apart from the real
    thing — which is the point. After a ``kill`` fault every call
    raises ``BackendUnavailable`` forever (``revive()`` undoes it, for
    recovery-after-replacement tests)."""

    _GUARDED = ("submit", "poll", "flush", "prewarm", "take_demand",
                "stats", "metrics", "compile_count", "ping")

    def __init__(self, inner, plan: FaultPlan, sleep=time.sleep):
        self.inner = inner
        self.plan = plan
        self.calls = 0
        self.killed = False
        self.faults_fired: list = []
        self._sleep = sleep

    @property
    def host_id(self) -> str:
        return self.inner.host_id

    @property
    def n_devices(self) -> int:
        return self.inner.n_devices

    def revive(self) -> None:
        self.killed = False

    def _guard(self, op: str) -> None:
        self.calls += 1
        if self.killed:
            raise BackendUnavailable(
                f"chaos: host {self.host_id} is dead")
        f = self.plan.fault_for(op, self.calls)
        if f is None:
            return
        self.faults_fired.append((self.calls, op, f.kind))
        if f.kind == "kill":
            self.killed = True
            raise BackendUnavailable(
                f"chaos: host {self.host_id} killed at call {self.calls}")
        if f.kind == "error":
            raise RemoteRequestError(
                self.host_id, "ChaosError",
                f"chaos: transient error at call {self.calls}")
        if f.kind == "freeze":
            if f.duration_s > 0:
                self._sleep(f.duration_s)
            raise BackendUnavailable(
                f"chaos: host {self.host_id} frozen "
                f"{f.duration_s:.3f}s at call {self.calls} (timeout)")
        if f.kind == "delay" and f.duration_s > 0:
            self._sleep(f.duration_s)

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in self._GUARDED and callable(attr):
            def guarded(*args, _attr=attr, _name=name, **kwargs):
                self._guard(_name)
                return _attr(*args, **kwargs)
            return guarded
        return attr

    def close(self) -> None:
        self.inner.close()


class ChaosProxy:
    """A byte-level TCP fault injector between a ``TcpBackend`` and a
    ``BackendServer``.

    Forwards both directions transparently until armed; then, once
    ``after_bytes`` of server->client traffic have passed, it either
    stalls (stops forwarding — the client blocks until its recv
    timeout fires) or severs (closes both sockets mid-frame — the
    client sees a reset / truncated frame). Arming at construction or
    later via ``trip()`` makes "let N replies through, then fail"
    scenarios deterministic at frame granularity.

        proxy = ChaosProxy(server_addr).start()
        backend = TcpBackend(proxy.address, recv_timeout_s=0.5)
        proxy.trip("stall")           # next reply never completes
    """

    def __init__(self, upstream, mode: str = "pass",
                 after_bytes: int = 0):
        if mode not in ("pass", "stall", "sever"):
            raise ValueError(f"unknown proxy mode {mode!r}")
        self.upstream = upstream
        self.mode = mode
        self.after_bytes = int(after_bytes)
        self.bytes_s2c = 0
        self.bytes_c2s = 0
        self.address = None
        self._lsock = None
        self._threads: list = []
        self._socks: list = []
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def start(self) -> "ChaosProxy":
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(0.2)
        self.address = self._lsock.getsockname()
        th = threading.Thread(target=self._accept_loop,
                              name="chaos-proxy", daemon=True)
        th.start()
        self._threads.append(th)
        return self

    def trip(self, mode: str, after_bytes: int | None = None) -> None:
        """Arm (or re-arm) the fault at runtime; counting is relative
        to the moment of arming."""
        if mode not in ("pass", "stall", "sever"):
            raise ValueError(f"unknown proxy mode {mode!r}")
        with self._lock:
            self.mode = mode
            if after_bytes is not None:
                self.after_bytes = int(after_bytes)
            self.bytes_s2c = 0

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                conn.close()
                continue
            self._socks += [conn, up]
            for src, dst, s2c in ((conn, up, False), (up, conn, True)):
                th = threading.Thread(
                    target=self._pump, args=(src, dst, s2c),
                    daemon=True)
                th.start()
                self._threads.append(th)

    def _pump(self, src, dst, s2c: bool) -> None:
        src.settimeout(0.2)
        while not self._stop.is_set():
            try:
                data = src.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            if s2c:
                with self._lock:
                    self.bytes_s2c += len(data)
                    mode = self.mode
                    tripped = (mode != "pass"
                               and self.bytes_s2c > self.after_bytes)
                if tripped and mode == "stall":
                    # swallow bytes until stopped: the client's recv
                    # timeout is now the only way out
                    self._stop.wait()
                    break
                if tripped and mode == "sever":
                    for s in (src, dst):
                        try:
                            s.close()
                        except OSError:
                            pass
                    break
            else:
                self.bytes_c2s += len(data)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        for th in self._threads:
            th.join(timeout=1.0)

    def __enter__(self) -> "ChaosProxy":
        return self.start() if self.address is None else self

    def __exit__(self, *exc) -> None:
        self.stop()
