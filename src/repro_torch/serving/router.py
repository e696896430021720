"""Cluster scheduler: bucket -> host routing and per-bucket autoscaling
(the port of the JAX package's ``repro.serving.router``, which is plain
Python and is kept as it is; its DESIGN.md §11 describes the design).

The paper's MP-AMP is a joint communication/computation trade-off; the
cluster tier is the serving-layer instance of it — *where* a bucket runs
decides both the compute a host burns and the bytes that cross host
boundaries. This module is the scheduler half of the frontend/scheduler/
backend split (Ray Serve's router/autoscaler structure):

  * ``routing_key`` — the placement-agnostic structural identity of a
    request (its ``BucketKey`` with placement pinned to "local"): each
    backend host re-derives its own mesh placement, the router only
    decides *which host*.
  * ``ClusterRouter`` — per-bucket replica sets over a static host list.
    Routing is load × shape aware: among a bucket's replicas it picks the
    host with the least outstanding *cost-weighted* work (``shape_cost``,
    a relative FLOP estimate, so one giant solve counts like many small
    ones), preferring hosts that have already compiled the bucket
    (prewarmed or previously served — a cold host pays its first-run
    set-up, kernel build and table builds, on first dispatch).
  * ``Autoscaler`` — consumes per-bucket admission-rate EWMAs
    (``DemandTracker`` fed from ``Batcher.take_demand`` scrape deltas)
    and moves each bucket's replica count toward
    ``ceil(rate * cost / target_load)``, clamped to
    [min_replicas, max_replicas]. Scale-up is immediate (under-provision
    costs latency now); scale-down waits ``down_patience`` consecutive
    low scrapes (hysteresis, so a demand dip doesn't thrash replicas and
    re-pay prewarm). Decisions are returned as events — the frontend
    applies them (prewarming the new host) and logs them.

Everything here is deterministic given the scrape timestamps: tests
drive ``observe``/``step`` with synthetic clocks.

Thread-safety: all router/autoscaler state is guarded by one reentrant
``ClusterRouter.lock`` (the autoscaler shares it — ``step`` calls back
into ``add_replica``/``remove_replica``, so the lock must nest).  The
frontend routes from caller threads while the scraper daemon steps the
autoscaler, and ``stats()``/``imbalance()`` must never observe a
half-applied route (outstanding bumped, served not yet) — the same
torn-read guarantee ``SolveService.stats()`` gives.
"""
from __future__ import annotations

import dataclasses
import math
import threading

from .buckets import BucketKey, BucketPolicy, bucket_for, placement_for

__all__ = ["routing_key", "shape_cost", "HostInfo", "RouterPolicy",
           "DemandTracker", "ClusterRouter", "Autoscaler", "Overloaded"]


class Overloaded(RuntimeError):
    """Admission refused: every replica of the bucket is at its
    outstanding-work cap (``RouterPolicy.max_outstanding``)."""


def routing_key(req, policy: BucketPolicy) -> BucketKey:
    """Placement-agnostic bucket identity of a request: layout resolves
    exactly as ``SolveService._prepare`` would (honoring an explicit
    ``req.layout``), placement is pinned to "local" — the chosen host's
    service re-derives data-parallel/processor-sharded placement for its
    own mesh."""
    layout = req.layout or placement_for(req.n, req.m, req.n_proc, 1,
                                         policy)[1]
    return bucket_for(req.n, req.m, req.n_proc, req.n_iter, req.transport,
                      policy, placement="local", layout=layout)


def shape_cost(key: BucketKey) -> float:
    """Relative per-request compute cost of a bucket: the dominant
    A-streaming work is 2 passes over the padded operand per iteration,
    so cost ∝ m_pad * n_pad * t_max (scaled to ~1.0 for a small serving
    bucket). Only ratios matter — the router balances cost-weighted
    outstanding work, the autoscaler prices demand in cost/s."""
    return key.m_pad * key.n_pad * key.t_max / 1e6


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One backend host as the router sees it. ``weight`` scales the
    host's capacity (device count by default): outstanding work is
    divided by it when comparing load across heterogeneous hosts."""

    host_id: str
    n_devices: int = 1

    @property
    def weight(self) -> float:
        return float(max(1, self.n_devices))


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Scheduler knobs (router + autoscaler + fault tolerance)."""

    ewma_halflife_s: float = 10.0   # demand-rate smoothing
    target_load: float = 50.0       # cost-units/s one replica should absorb
    min_replicas: int = 1
    max_replicas: int = 0           # 0 = every host
    down_patience: int = 3          # consecutive low scrapes before scale-down
    max_outstanding: float = 0.0    # per-host cost-weighted admission cap
    #                                 (0 = unbounded); breaching it on every
    #                                 replica sheds the request (Overloaded)
    prefer_prewarmed: bool = True   # cold hosts lose routing ties
    scrape_every_s: float = 0.0     # frontend auto-scrape period (0 = manual)
    # fault tolerance (DESIGN.md §13): consecutive connection-level
    # failures (BackendUnavailable from calls or health probes) walk a
    # host healthy -> suspect -> dead; dead hosts are evicted from every
    # replica set and their in-flight requests re-admitted elsewhere
    suspect_after: int = 1          # failures before a host turns suspect
    dead_after: int = 3             # failures before a host is declared dead
    retry_limit: int = 2            # re-admissions per request before lost
    retry_backoff_s: float = 0.05   # base backoff between submit retries
    hedge_p99_mult: float = 0.0     # duplicate in-flight requests older
    #                                 than mult * p99 latency (0 = off)
    shed_ladder: bool = False       # graceful-degradation ladder: strip
    #                                 wire/telemetry extras, then degrade
    #                                 the schedule (SE-quoted), before
    #                                 shedding with Overloaded


class DemandTracker:
    """Per-bucket admission-rate EWMAs from scrape deltas.

    ``update(deltas, now)`` folds one scrape window in: every tracked
    rate decays by 2^(-dt/halflife) and the window's mean rate
    (delta/dt) contributes the complementary weight — so a bucket that
    stops arriving decays toward zero (the autoscaler's scale-down
    signal) instead of pinning its peak forever."""

    def __init__(self, halflife_s: float):
        self.halflife_s = float(halflife_s)
        self._rate: dict[BucketKey, float] = {}
        self._t_last: float | None = None

    def update(self, deltas: dict, now: float) -> None:
        if self._t_last is None:
            # first scrape has no window length: seed rates at 0 and
            # start the clock (a huge bogus dt would swamp the EWMA)
            self._t_last = float(now)
            for key in deltas:
                self._rate.setdefault(key, 0.0)
            return
        dt = float(now) - self._t_last
        if dt <= 0.0:
            return
        self._t_last = float(now)
        decay = 2.0 ** (-dt / self.halflife_s)
        for key in set(self._rate) | set(deltas):
            inst = deltas.get(key, 0) / dt
            self._rate[key] = (self._rate.get(key, 0.0) * decay
                               + inst * (1.0 - decay))

    def rate(self, key: BucketKey) -> float:
        return self._rate.get(key, 0.0)

    def rates(self) -> dict:
        return dict(self._rate)


class ClusterRouter:
    """Assigns buckets to hosts: replica sets + least-loaded routing."""

    def __init__(self, hosts: "list[HostInfo]",
                 policy: RouterPolicy | None = None):
        assert hosts, "router needs at least one host"
        self.hosts = list(hosts)
        self.policy = policy or RouterPolicy()
        # One reentrant lock over ALL router + autoscaler mutable state
        # (module docstring): reentrant because Autoscaler.step ->
        # add_replica nests, shared so cross-object invariants
        # (replica sets vs demand rates) snapshot consistently.
        self.lock = threading.RLock()
        self._by_id = {h.host_id: h for h in hosts}
        assert len(self._by_id) == len(hosts), "duplicate host ids"
        self._replicas: dict[BucketKey, list[str]] = {}
        self._outstanding: dict[str, float] = {h.host_id: 0.0
                                               for h in hosts}
        # lifetime routed requests / cost per host — the imbalance metric
        self._served: dict[str, int] = {h.host_id: 0 for h in hosts}
        self._served_cost: dict[str, float] = {h.host_id: 0.0
                                               for h in hosts}
        # (host, key) pairs known to hold a compiled program (prewarmed
        # or served at least once): routing prefers them
        self._warm: set = set()
        # host state machine (DESIGN.md §13): healthy -> suspect (probe
        # failures, deprioritized at routing ties) -> dead (evicted from
        # every replica set, in-flight failed over) and draining (planned
        # removal: no new routes, outstanding work finishes). The
        # *frontend* counts failures and calls the mark_* transitions —
        # it sees the typed errors; the router only holds the state.
        self._state: dict[str, str] = {h.host_id: "healthy" for h in hosts}

    # -- host state machine --------------------------------------------------

    def host_state(self, host_id: str) -> str:
        with self.lock:
            return self._state[host_id]

    def host_states(self) -> "dict[str, str]":
        with self.lock:
            return dict(self._state)

    def _routable(self, host_id: str) -> bool:
        return self._state[host_id] in ("healthy", "suspect")

    def alive_hosts(self) -> "list[str]":
        """Hosts new work may route to (healthy or suspect)."""
        with self.lock:
            return [h.host_id for h in self.hosts
                    if self._routable(h.host_id)]

    def mark_suspect(self, host_id: str) -> None:
        """Healthy -> suspect (failed probes below the dead threshold).
        Suspect hosts still route — they lose ties to healthy replicas —
        but hedging targets their in-flight tail."""
        with self.lock:
            if self._state[host_id] == "healthy":
                self._state[host_id] = "suspect"

    def mark_healthy(self, host_id: str) -> None:
        """Probe succeeded: suspect hosts recover; a dead host revives
        (it rejoins routing and the autoscaler may re-add replicas)."""
        with self.lock:
            self._state[host_id] = "healthy"

    def mark_dead(self, host_id: str) -> "list[BucketKey]":
        """Declare a host dead: evict it from every replica set, zero its
        outstanding work (those requests are being failed over — their
        cost re-enters on the host that re-admits them), and return the
        bucket keys that lost a replica so the frontend can re-plan.
        Buckets left with no live replica refill lazily on the next
        ``route``/``add_replica`` (which skip dead hosts)."""
        with self.lock:
            self._state[host_id] = "dead"
            self._outstanding[host_id] = 0.0
            affected = []
            for key, reps in self._replicas.items():
                if host_id in reps:
                    reps.remove(host_id)
                    affected.append(key)
            return affected

    def drain(self, host_id: str) -> None:
        """Graceful removal: no new routes; in-flight work completes."""
        with self.lock:
            if self._state[host_id] != "dead":
                self._state[host_id] = "draining"

    # -- replica sets --------------------------------------------------------

    def replicas(self, key: BucketKey) -> "list[str]":
        with self.lock:
            return list(self._ensure(key))

    def _max_replicas(self) -> int:
        mr = self.policy.max_replicas
        return len(self.hosts) if mr <= 0 else min(mr, len(self.hosts))

    def _load(self, host_id: str) -> float:
        return self._outstanding[host_id] / self._by_id[host_id].weight

    def _ensure(self, key: BucketKey) -> "list[str]":
        reps = self._replicas.get(key)
        if reps is None:
            # first sight: min_replicas live hosts, least loaded first
            # (stable host order breaks ties so assignment is
            # deterministic); dead/draining hosts never join
            n = min(max(1, self.policy.min_replicas), len(self.hosts))
            pool = [h for h in self.hosts if self._routable(h.host_id)]
            order = sorted(pool,
                           key=lambda h: (self._load(h.host_id),
                                          self.hosts.index(h)))
            reps = self._replicas[key] = [h.host_id for h in order[:n]]
        return reps

    def _grow_locked(self, key: BucketKey, reps: "list[str]",
                     avoid=()) -> str | None:
        """Append the least-loaded live non-member host to ``reps``;
        None when no live host is available or the set is saturated."""
        if len(reps) >= self._max_replicas():
            return None
        candidates = [h for h in self.hosts
                      if h.host_id not in reps and h.host_id not in avoid
                      and self._routable(h.host_id)]
        if not candidates:
            return None
        host = min(candidates, key=lambda h: (self._load(h.host_id),
                                              self.hosts.index(h)))
        reps.append(host.host_id)
        return host.host_id

    def add_replica(self, key: BucketKey) -> str | None:
        """Grow the bucket's replica set by the least-loaded live
        non-member host; returns its id (None when saturated)."""
        with self.lock:
            return self._grow_locked(key, self._ensure(key))

    def remove_replica(self, key: BucketKey) -> str | None:
        """Shrink the bucket's replica set (never below min_replicas):
        drops the most recently added member — the longest-standing
        replicas hold the warmest caches."""
        with self.lock:
            reps = self._ensure(key)
            if len(reps) <= max(1, self.policy.min_replicas):
                return None
            return reps.pop()

    # -- routing -------------------------------------------------------------

    def route(self, key: BucketKey, cost: float,
              prefer: str | None = None, avoid=()) -> str:
        """Pick the host for one request and account its outstanding
        cost. A ``prefer`` replica under the admission cap wins outright
        — the frontend passes the host holding the bucket's open partial
        batch, so a filling batch is not split across hosts mid-stream
        (splitting costs an extra program dispatch AND changes padded
        widths, breaking bit-identity with a single-host service).
        Otherwise, among the bucket's *live* replicas (dead/draining
        hosts never route; ``avoid`` lists hosts the caller is retrying
        away from): least cost-weighted outstanding work first, then —
        at equal load — healthy before suspect, then prewarmed/
        previously-served hosts before cold ones (a cold host pays its
        first-run set-up on first dispatch; warmth must only break ties, or the
        first-served host would win every route and capacity added by
        the autoscaler would never drain load), then stable host order.
        A bucket whose replicas all died refills from the surviving
        hosts here (the autoscaler replaces capacity on its next step;
        this keeps the *next request* routable immediately). Raises
        ``Overloaded`` when no live replica exists or an admission cap is
        set and every live replica is at it."""
        with self.lock:
            reps = self._ensure(key)
            # a death may have shrunk the set below min_replicas: top it
            # back up from survivors (membership ignores ``avoid`` — the
            # pick below still honors it)
            target = min(max(1, self.policy.min_replicas),
                         sum(1 for h in self.hosts
                             if self._routable(h.host_id)))
            while sum(1 for hid in reps if self._routable(hid)) < target:
                if self._grow_locked(key, reps) is None:
                    break
            live = [hid for hid in reps
                    if self._routable(hid) and hid not in avoid]
            if not live:
                grown = self._grow_locked(key, reps, avoid)
                if grown is None:
                    # an avoided host is better than failing outright
                    live = [hid for hid in reps if self._routable(hid)]
                    if not live:
                        raise Overloaded(f"no live replica for {key}")
                else:
                    live = [grown]
            cap = self.policy.max_outstanding
            if (prefer in live
                    and (cap <= 0.0 or self._outstanding[prefer] < cap)):
                self._outstanding[prefer] += cost
                self._served[prefer] += 1
                self._served_cost[prefer] += cost
                self._warm.add((prefer, key))
                return prefer
            ranked = sorted(
                live,
                key=lambda hid: (self._load(hid),
                                 self._state[hid] == "suspect",
                                 (hid, key) not in self._warm
                                 if self.policy.prefer_prewarmed else False,
                                 self.hosts.index(self._by_id[hid])))
            if cap > 0.0:
                ranked = [hid for hid in ranked
                          if self._outstanding[hid] < cap]
                if not ranked:
                    raise Overloaded(
                        f"all {len(reps)} replica(s) of {key} at the "
                        f"outstanding cap {cap}")
            host_id = ranked[0]
            self._outstanding[host_id] += cost
            self._served[host_id] += 1
            self._served_cost[host_id] += cost
            self._warm.add((host_id, key))
            return host_id

    def complete(self, host_id: str, cost: float) -> None:
        """Return one routed request's cost (result delivered). Snaps
        tiny float residue to exactly zero so a fully drained host ties
        (and loses to host order) instead of ranking on leftover eps."""
        with self.lock:
            left = self._outstanding[host_id] - cost
            self._outstanding[host_id] = 0.0 if left < 1e-9 else left

    def mark_warm(self, host_id: str, key: BucketKey) -> None:
        """Record a prewarmed (host, bucket) pair (frontend prewarm)."""
        with self.lock:
            self._warm.add((host_id, key))

    # -- observability -------------------------------------------------------

    def imbalance(self) -> float:
        """Cost-weighted served-work ratio max/min across hosts (1.0 =
        perfectly balanced; hosts that served nothing count as the
        smallest share). Dead hosts are excluded — a mid-run host death
        is a fault, not a balance failure. The cluster bench's balance
        gate."""
        with self.lock:
            shares = [self._served_cost[h.host_id]
                      / self._by_id[h.host_id].weight for h in self.hosts
                      if self._state[h.host_id] != "dead"]
            if not shares:
                return 1.0
            hi = max(shares)
            if hi <= 0.0:
                return 1.0
            lo = min(shares)
            return math.inf if lo <= 0.0 else hi / lo

    def stats(self) -> dict:
        with self.lock:
            return {
                "hosts": [h.host_id for h in self.hosts],
                "outstanding": dict(self._outstanding),
                "served": dict(self._served),
                "served_cost": {k: round(v, 3)
                                for k, v in self._served_cost.items()},
                "imbalance": self.imbalance(),
                "replicas": {str(k): list(v)
                             for k, v in self._replicas.items()},
                "warm_programs": len(self._warm),
                "states": dict(self._state),
            }


class Autoscaler:
    """Per-bucket replica scaling from demand EWMAs (Ray Serve style:
    the router owns placement state, the autoscaler only moves replica
    counts and reports events)."""

    def __init__(self, router: ClusterRouter,
                 policy: RouterPolicy | None = None):
        self.router = router
        self.policy = policy or router.policy
        # Shares the router's reentrant lock: step() mutates replica sets
        # through router methods, and stats scrapes must not tear across
        # the rates/events pair while a step is mid-flight.
        self.lock = router.lock
        self.tracker = DemandTracker(self.policy.ewma_halflife_s)
        self._below: dict[BucketKey, int] = {}
        self.events: list = []

    def observe(self, deltas: dict, now: float) -> None:
        """Feed one scrape window of per-bucket admission deltas."""
        with self.lock:
            self.tracker.update(deltas, now)

    def desired_replicas(self, key: BucketKey) -> int:
        """ceil(rate * cost / target_load), clamped — the replica count
        whose per-replica load sits at or under the target."""
        with self.lock:
            load = self.tracker.rate(key) * shape_cost(key)
            want = math.ceil(load / self.policy.target_load)
            lo = max(1, self.policy.min_replicas)
            hi = self.router._max_replicas()
            return min(max(want, lo), hi)

    def step(self, now: float | None = None) -> list:
        """One autoscaling pass over every tracked bucket; returns the
        applied events as ``("scale_up"|"scale_down", key, host_id)``
        tuples (also appended to ``self.events``). Scale-up applies
        immediately; scale-down needs ``down_patience`` consecutive
        passes below the threshold."""
        with self.lock:
            return self._step_locked()

    def _step_locked(self) -> list:
        events = []
        for key in self.tracker.rates():
            current = len(self.router.replicas(key))
            desired = self.desired_replicas(key)
            if desired > current:
                self._below.pop(key, None)
                for _ in range(desired - current):
                    host = self.router.add_replica(key)
                    if host is None:
                        break
                    events.append(("scale_up", key, host))
            elif desired < current:
                seen = self._below.get(key, 0) + 1
                self._below[key] = seen
                if seen >= max(1, self.policy.down_patience):
                    self._below[key] = 0
                    host = self.router.remove_replica(key)
                    if host is not None:
                        events.append(("scale_down", key, host))
            else:
                self._below.pop(key, None)
        self.events.extend(events)
        return events

    def stats(self) -> dict:
        with self.lock:
            return {
                "rates": {str(k): round(v, 4)
                          for k, v in self.tracker.rates().items()},
                "events": [(kind, str(k), host)
                           for kind, k, host in self.events],
            }
