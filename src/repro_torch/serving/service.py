"""AMP solve service on one device: heterogeneous requests -> bucketed
batched engine calls -> per-request results with realized-rate accounting
(the port of the JAX package's ``repro.serving.service``; its DESIGN.md §5,
§9 and §12 describe the design).

One ``SolveService`` owns a cache of ``AmpEngine``s (one per
``BucketKey``), a table cache of per-operating-point BT controllers, a
device-resident operand cache and a ``Batcher``. Requests may differ in
everything the paper varies — shape (N, M), processor count P, prior
sparsity, SNR, iteration budget T, and rate policy (lossless / fixed
schedule / offline DP / online BT) — and in transport (ECSQ, int8/int4
blocks), and the service still runs them as a handful of batched
``solve_het`` calls: structural parameters select the bucket, everything
else rides as per-instance operands (``HetParams``). Engine calls return
before the device finishes (PyTorch queues the kernels); results come to
the host when a consumer pulls them, so the host pads the next batch while
the device computes.

On a device mesh (``mesh=``, a ``launch/mesh.py::Mesh`` of D ranks) the
service places buckets as the reference does: mid-size requests batch
*data-parallel* (the padded batch rounded up to a multiple of D, each rank
solving its B / D instances with its own ``dispatch_het``, the results
gathered on rank 0), large single requests run *processor-sharded* (every
rank runs ``dispatch_sharded`` on its P / D processors, the fusion a
collective). The mesh is SPMD: rank 0 owns the ``SolveService``, every
other rank runs ``serve_mesh_worker(mesh)``. Rank 0 broadcasts each
command (a header of numpy operands); each rank keeps its shards of A in
its own operand cache keyed by the request's fingerprint, so a repeated
request sends only y and the parameters; every command ends in a status
every rank reads, so a failure on one rank ends the others' wait;
``close()`` stops the workers.

What the reference has and this one does not: operand donation and
ahead-of-time compilation (PyTorch runs eagerly: ``prewarm`` builds the
kernels and runs each program once instead, and ``compile_count`` counts
those distinct first runs). The cluster tier over several services is
``serving.frontend``.

Usage::

    svc = SolveService()                      # the card; device="cpu" to test
    results = svc.solve([SolveRequest(y=y, a=a, prior=prior, policy="bt"),
                         SolveRequest(y=y2, a=a2, n_iter=6, policy="fixed",
                                      deltas=np.full(6, 0.05)), ...])

or streaming (continuous batching)::

    for res in svc.stream(request_iter):
        ...  # results arrive per request as each bucket batch completes
"""
from __future__ import annotations

import dataclasses
import math
import operator
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

from .. import convert
from ..core.collectives import (broadcast_object, gather_object, recv_tensor,
                                send_tensor)
from ..core.denoisers import BernoulliGauss
from ..core.engine import (AmpEngine, BlockQuantTransport, BTRateControl,
                           BTTables, ColBTTables, ColDPSchedule,
                           ColumnBTRateControl, ColumnPartition,
                           CompressedPsumTransport, DPSchedule,
                           EcsqTransport, EngineConfig, EngineTrace,
                           ErasureSpec, HetParams, PsumFusion, RowPartition,
                           pad_bt_tables, rank_slice, split_problem_cols,
                           stack_bt_tables)
from ..core.quantize import ecsq_entropy, message_mixture, residual_mixture
from ..core.rate_alloc import (dp_allocate, dp_allocate_col,
                               erasure_rate_factors, stack_schedules)
from ..core.rate_distortion import RDModel
from ..core.state_evolution import CSProblem
from ..telemetry import (DRIFT_ALERT, DRIFT_BUCKETS, MetricsRegistry,
                         prometheus_text, se_drift, se_drift_batch)
from ..telemetry.spans import now as _tnow
from ..telemetry.spans import span as _tspan
from .batcher import Batcher
from .buckets import (BucketKey, BucketPolicy, batch_width_ladder,
                      bucket_for, pad_batch_size, placement_for, round_up)
from .operand_cache import OperandCache, fingerprint
from .wire import WireModel, measure_wire

__all__ = ["SolveRequest", "SolveResult", "SolveService", "PrewarmSpec",
           "serve_mesh_worker"]


@dataclasses.dataclass
class SolveRequest:
    """One CS recovery request: y = A s0 + e, recover s0.

    ``policy`` selects the rate control:
      * ``"lossless"`` — exact fusion (the paper's 32-bit baseline),
      * ``"fixed"``    — caller-provided per-iteration bin sizes ``deltas``,
      * ``"dp"``       — offline-optimal DP allocation for ``dp_total_bits``
                         (paper Sec. 3.4); ``deltas`` may be pre-computed,
                         otherwise the service runs ``dp_allocate`` (the
                         RD model table is disk-cached per prior),
      * ``"bt"``       — online back-tracking (paper Sec. 3.3); its tables
                         are built once per operating point (prior, SNR,
                         kappa, P, T) and cached on the device.

    ``layout`` selects the partition scheme: ``None`` routes by aspect
    ratio (``placement_for``), ``"row"``/``"col"`` force one. Column
    requests need N divisible by P; every policy works in either layout —
    the service builds the matching controller family (``dp_allocate_col``
    / ``ColumnBTRateControl`` for column buckets).

    ``transport`` is ``"ecsq"`` or the fixed-width ``"block8"`` /
    ``"block4"`` (rate policy ``"lossless"`` only: the wire width fixes the
    rate). ``erasure_rate`` > 0 subjects the request's fusion packets to
    per-round, per-processor loss (``erasure_model``: i.i.d.
    ``"bernoulli"`` or bursty ``"gilbert"`` with mean burst
    ``erasure_burst``; the mask is drawn deterministically from
    ``erasure_seed``). ``recovery`` selects the bit accounting:
    ``"retransmit"`` (a dropped packet is re-sent) or ``"rate_up"`` (the
    survivors spend the dropped share); see ``rate_alloc``. Erasure
    requests run on the batched path. ``measure_wire`` opts the request into measured-bytes
    accounting: the engine traces the quantizer symbol streams and the
    service rANS-codes them on the host (``serving.wire``), reporting
    ``bytes_on_wire`` / ``time_on_air_s`` / ``energy_j`` on the result.
    """

    y: np.ndarray
    a: np.ndarray
    prior: BernoulliGauss = dataclasses.field(default_factory=BernoulliGauss)
    snr_db: float = 20.0
    n_proc: int = 10
    n_iter: int = 8
    policy: str = "lossless"
    deltas: np.ndarray | None = None      # fixed / precomputed dp
    dp_total_bits: float | None = None    # dp (default 2.0 * n_iter)
    bt_c_ratio: float = 1.005
    bt_r_max: float = 6.0
    transport: str = "ecsq"               # "ecsq" | "block8" | "block4"
    layout: str | None = None             # None = auto | "row" | "col"
    erasure_rate: float = 0.0             # per-packet loss probability
    erasure_model: str = "bernoulli"      # "bernoulli" | "gilbert"
    erasure_burst: float = 4.0            # mean burst length (gilbert)
    erasure_seed: int = 0                 # mask draw (deterministic)
    recovery: str = "retransmit"          # "retransmit" | "rate_up"
    measure_wire: bool = False            # rANS-code symbol streams and
    #                                       report measured wire bytes
    a_id: str | None = None               # stable caller-managed identity of
    #                                       ``a`` for the operand cache; when
    #                                       set it replaces the content hash
    #                                       (the caller vouches the bytes
    #                                       behind one id never change)
    request_id: int = -1                  # assigned at submit
    spans: list | None = None             # telemetry trace spans
    #                                       ([name, host, t0, t1] lists,
    #                                       telemetry/spans.py)

    @property
    def n(self) -> int:
        return self.a.shape[1]

    @property
    def m(self) -> int:
        return self.a.shape[0]

    def problem(self) -> CSProblem:
        return CSProblem(n=self.n, m=self.m, prior=self.prior,
                         snr_db=self.snr_db)


@dataclasses.dataclass
class SolveResult:
    """Per-request output, unpadded back to the request's own (N, T).

    ``rates`` is the per-iteration coding rate *per processor, in the
    layout's own wire unit* — bits per signal element for row buckets,
    bits per *measurement* for column buckets (``bucket.layout`` tells them
    apart; mixed-stream consumers must not sum across layouts). The value
    is the BT controller's decision for ``policy="bt"``, the analytic ECSQ
    entropy H_Q of the model payload distribution for finite fixed/DP bins,
    the fixed wire width (bits + amortized bf16 scale) for block
    transports, and +inf for lossless-fusion iterations (untracked,
    excluded from ``total_bits``).
    """

    request_id: int
    x: np.ndarray             # (N,) final estimate
    sigma2_hat: np.ndarray    # (T,) plug-in variances: post-LC (row) /
    #                           post-fusion ||g||^2/M incl. quant (col)
    deltas: np.ndarray        # (T,) realized bin sizes (inf = lossless)
    extra_var: np.ndarray     # (T,) transport-injected variance P*sigma_Q^2
    rates: np.ndarray         # (T,) bits/elem (row) | bits/meas (col), /proc
    total_bits: float         # sum of finite per-iteration rates
    bucket: BucketKey         # where this request was executed
    batch_size: int           # real requests in the executed batch
    bytes_on_wire: float | None = None   # measured rANS bytes incl. table/
    #                                      header (measure_wire)
    payload_bytes: float | None = None   # measured rANS payload only — the
    #                                      number comparable to model H_Q
    time_on_air_s: float | None = None   # bytes_on_wire / link rate
    energy_j: float | None = None        # time_on_air * tx power
    se_drift: float | None = None        # mean |ln(realized/SE predicted)|
    #                                      per-iteration variance drift
    #                                      (telemetry/drift.py); None when
    #                                      telemetry is off
    spans: list | None = None            # completed trace spans
    #                                      (admit..complete)

    def mse(self, s0: np.ndarray) -> float:
        return float(np.mean((self.x - np.asarray(s0)) ** 2))

    @property
    def tracked(self) -> bool:
        """Whether ``total_bits`` is a real measurement: False when no
        iteration reported a finite rate (all-lossless fusion), in which
        case the 0.0 total means "untracked", not "zero bits"."""
        return bool(np.isfinite(self.rates).any())


@dataclasses.dataclass(frozen=True)
class PrewarmSpec:
    """One entry of a prewarm menu: the structural shape of expected
    traffic. ``SolveService.prewarm`` expands each spec into its bucket x
    batch-width grid and runs every program once, so steady-state requests
    find their kernels built and their tables and schedules cached.

    ``policy`` picks the program family: "lossless"/"fixed"/"dp" share the
    program without a BT controller, "bt" runs the controller's (and warms
    the BT table cache for (prior, snr_db)). "dp" additionally warms the
    DP/RD allocation caches, which builds an RD table on first sight of a
    prior — only list it when that cost belongs in start-up.

    ``batch_widths=None`` runs the full ``batch_width_ladder`` of the
    service policy; pass an explicit tuple to narrow start-up cost."""

    n: int
    m: int
    n_proc: int = 10
    n_iter: int = 8
    policy: str = "lossless"
    transport: str = "ecsq"
    layout: str | None = None
    snr_db: float = 20.0
    prior: BernoulliGauss = dataclasses.field(default_factory=BernoulliGauss)
    batch_widths: tuple | None = None


_TRANSPORTS = {
    "ecsq": EcsqTransport,
    "block8": lambda: BlockQuantTransport(bits=8, block=512),
    "block4": lambda: BlockQuantTransport(bits=4, block=512),
}

# processor-sharded engines fuse on the mesh instead: the same wire format,
# executed as a collective
_SHARDED_TRANSPORTS = {
    "ecsq": lambda: PsumFusion(local=EcsqTransport()),
    "block8": lambda: CompressedPsumTransport(bits=8, block=512),
    "block4": lambda: CompressedPsumTransport(bits=4, block=512),
}


def _bucket_engine(key: BucketKey, wire: bool, collect_xs: bool,
                   device) -> AmpEngine:
    """The engine of a bucket (rank 0's and every worker's alike): its
    prior rides per instance (``HetParams``), so the engine's is unused.
    Processor-sharded buckets fuse over the mesh."""
    if wire and key.placement == "proc":
        raise ValueError(
            "measured-wire accounting needs the symbol streams on one "
            "device; the processor-sharded placement keeps them per rank "
            "(pin layout/shape to a local or data-parallel bucket)")
    cfg = EngineConfig(
        n_proc=key.n_proc, n_iter=key.t_max, collect_symbols=wire,
        collect_xs=collect_xs,
        layout=(ColumnPartition(n_inner=1) if key.layout == "col"
                else RowPartition()),
        device=str(device))
    transport = (_SHARDED_TRANSPORTS[key.transport]()
                 if key.placement == "proc" else _TRANSPORTS[key.transport]())
    return AmpEngine(BernoulliGauss(), cfg, transport)


def _engine_key(key: BucketKey) -> BucketKey:
    """Data-parallel buckets share the local engine: the sharding is of the
    batch, not of the solve."""
    return key if key.placement == "proc" else dataclasses.replace(
        key, placement="local")


_INSTANCE_FIELDS = ("sched", "t_active", "m_real", "n_real", "eps", "mu_s",
                    "sigma_s", "use_bt", "drop")


def _instances(params: HetParams, sl, has_bt: bool) -> HetParams:
    """Instances ``sl`` (a slice, or an int: one instance without its batch
    axis) of ``HetParams``. The BT tables are stacked only when some
    instance decides by BT (``has_bt``); otherwise they are one unread set,
    taken as it is."""
    take = lambda v: None if v is None else v[sl]
    return params._replace(
        **{f: take(getattr(params, f)) for f in _INSTANCE_FIELDS},
        bt=type(params.bt)(*(v[sl] for v in params.bt)) if has_bt
        else params.bt)


def _params_arrays(params: HetParams) -> dict:
    """Device ``HetParams`` as numpy, by field name (a worker rebuilds them
    with ``convert.het_params_from_arrays``)."""
    host = lambda v: None if v is None else v.cpu().numpy()
    return {**{f: host(getattr(params, f)) for f in _INSTANCE_FIELDS},
            "bt": [host(v) for v in params.bt]}


def _concat_traces(traces: list) -> EngineTrace:
    """Batched traces of the ranks, one after the other on the batch axis."""
    cat = lambda vs: None if vs[0] is None else np.concatenate(vs)
    return EngineTrace(**{f.name: cat([getattr(t, f.name) for t in traces])
                          for f in dataclasses.fields(EngineTrace)})


# the CUDA sources a bucket's solves launch kernels of
_SOURCES = {"row": ("amp_local", "quantize"), "col": ("amp_col", "quantize")}

# a dispatched-but-unmaterialized engine call: calling it brings the
# device results to the host as SolveResults
_Pending = Callable[[], "list[SolveResult]"]

# sentinel: _finish_telemetry computes the drift itself (singleton path);
# the batched path passes a precomputed value
_COMPUTE = object()

# the operating-point fields that must agree across a bucket group for the
# vectorized drift path
_DRIFT_ATTRS = operator.attrgetter("n_iter", "n", "m", "snr_db",
                                   "erasure_rate")


class SolveService:
    """Shape-bucketed continuous batching over ``AmpEngine.solve_het``, with
    mesh-aware bucket placement when a device mesh is given (rank 0 of the
    mesh owns the service; see the module docstring)."""

    def __init__(self, policy: BucketPolicy | None = None,
                 collect_xs: bool = False, rate_accounting: bool = True,
                 mesh=None, operand_cache_bytes: int = 256 << 20,
                 singleton_fastpath: bool = True,
                 wire_model: WireModel | None = None,
                 telemetry: bool = True, device: str = "cuda"):
        self.mesh = mesh
        self.n_devices = 1 if mesh is None else mesh.size
        if mesh is not None:
            if mesh.rank != 0:
                raise ValueError("rank 0 of the mesh owns the SolveService; "
                                 "the other ranks run serve_mesh_worker")
            device = str(mesh.device)
        # raises without a card: the service never carries on on the CPU
        # unless asked to
        self.device = EngineConfig(device=device).torch_device
        self.policy = policy or BucketPolicy()
        if self.n_devices > 1 and self.policy.max_batch % self.n_devices:
            # data-parallel dispatch pads batches to a device multiple
            raise ValueError(
                f"max_batch={self.policy.max_batch} must be a multiple of "
                f"the mesh device count ({self.n_devices})")
        self.collect_xs = collect_xs
        self.rate_accounting = rate_accounting
        self.wire_model = wire_model or WireModel()
        self._batcher = Batcher(self.policy)
        self._engines: dict[BucketKey, AmpEngine] = {}
        # symbol-tracing twins of the bucket engines for measured-wire
        # requests (a bigger trace: a separate program family)
        self._wire_engines: dict[BucketKey, AmpEngine] = {}
        self._bt_cache: dict = {}
        self._dummy_tables: dict = {}
        self._rd_cache: dict = {}
        self._completed: list[SolveResult] = []
        self._pending: list[_Pending] = []
        self._next_id = 0
        # device-resident A shards keyed by content fingerprint (0 bytes
        # disables) and plain-dispatch routing for lone row requests
        self._opcache = (OperandCache(operand_cache_bytes)
                         if operand_cache_bytes > 0 else None)
        self.singleton_fastpath = singleton_fastpath
        self._single_engines: dict = {}
        self._singleton_dispatches = 0
        self._prewarm_report: dict | None = None
        self._prewarm_thread: threading.Thread | None = None
        # guards id assignment and engine-map mutation against a background
        # prewarm thread racing foreground submits
        self._lock = threading.RLock()
        # telemetry plane: event-driven histograms/counters on the request
        # path plus a pull-time collector over the sources that keep their
        # own counters (engines, operand cache, batcher). ``telemetry=False``
        # strips every hot-path write.
        self.telemetry = telemetry
        self._registry = None
        self._children: dict = {}
        if telemetry:
            reg = self._registry = MetricsRegistry()
            self._m_requests = reg.counter(
                "amp_requests_total",
                "Requests admitted (counted at group dispatch)",
                ("layout",))
            self._h_latency = reg.histogram(
                "amp_request_latency_seconds",
                "Admit -> result-finalized latency", ("layout",))
            self._h_batch_wait = reg.histogram(
                "amp_batch_wait_seconds",
                "Admit -> bucket batch dispatch wait", ("layout",))
            self._h_drift = reg.histogram(
                "amp_se_drift",
                "Per-request SE drift: mean |ln(realized/predicted)| "
                "per-iteration variance", ("layout",),
                buckets=DRIFT_BUCKETS)
            self._m_drift_alerts = reg.counter(
                "amp_se_drift_alerts_total",
                f"Requests whose SE drift exceeded {DRIFT_ALERT}",
                ("layout",))
            reg.collect(self._collect_metrics)

    # -- request intake ------------------------------------------------------

    def submit(self, req: SolveRequest) -> int:
        """Queue one request; a full bucket group dispatches immediately
        (results buffered until ``flush``/``stream``/``poll`` hands them
        out)."""
        t_admit = _tnow() if self.telemetry else 0.0
        req = self._prepare(req)
        key = self._key_for(req)
        if self.telemetry:
            # a forwarded request's span list is extended on an own copy;
            # a local request stashes only the admit timestamp, and the
            # dispatch tails build its spans
            sp = req.spans
            if sp:
                req.spans = [*sp, ["admit", None, t_admit, _tnow()]]
            else:
                req._t_admit = t_admit
        full = self._batcher.add(key, req)
        if full is not None:
            self._pending.append(self._dispatch_bucket(*full))
        return req.request_id

    def _collect_pending(self):
        """Bring every dispatched batch to the host, into ``_completed``
        (FIFO)."""
        pending, self._pending = self._pending, []
        for finalize in pending:
            self._completed.extend(finalize())

    def poll(self) -> list[SolveResult]:
        """Finish every *already dispatched* batch and hand back all
        buffered results — without forcing partially-filled bucket groups
        to dispatch (unlike ``flush``)."""
        self._collect_pending()
        out, self._completed = self._completed, []
        return out

    def flush(self) -> list[SolveResult]:
        """Dispatch all pending groups; return every buffered result."""
        # dispatch everything first, then bring results back: the device
        # works on one group while the host pads the next group's operands
        for key, group in self._batcher.drain():
            self._pending.append(self._dispatch_bucket(key, group))
        self._collect_pending()
        out, self._completed = self._completed, []
        return out

    def solve(self, reqs) -> list[SolveResult]:
        """Submit + flush; results in submission order. Results belonging
        to earlier ``submit`` calls that this flush happened to complete
        stay buffered for their own ``flush``/``stream`` consumer."""
        ids = [self.submit(r) for r in reqs]
        own = set(ids)
        by_id = {}
        for r in self.flush():
            if r.request_id in own:
                by_id[r.request_id] = r
            else:
                self._completed.append(r)
        return [by_id[i] for i in ids]

    def stream(self, reqs):
        """Continuous batching: yield results per request as each bucket
        batch completes; stragglers flush when the input is exhausted.
        Like ``solve``, results belonging to other consumers' earlier
        ``submit`` calls stay buffered for them."""
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
            # finish whatever submit dispatched: stream's contract is a
            # yield per completed batch
            self._collect_pending()
            if self._completed:
                yield from take_own()
        for key, group in self._batcher.drain():
            self._pending.append(self._dispatch_bucket(key, group))
        self._collect_pending()
        yield from take_own()

    # -- internals -----------------------------------------------------------

    def _prepare(self, req: SolveRequest,
                 assign_id: bool = True) -> SolveRequest:
        if req.request_id >= 0:
            # template reuse: resubmitting an already-served request object
            # must not alias two queue entries onto one id, nor inherit the
            # previous serve's spans (a list ending in "route" is a cluster
            # frontend's in-flight handoff, which the backend extends)
            fwd = bool(req.spans) and req.spans[-1][0] == "route"
            req = dataclasses.replace(req, spans=req.spans if fwd else None)
        if assign_id:
            with self._lock:
                req.request_id = self._next_id
                self._next_id += 1
        if req.policy not in ("lossless", "fixed", "dp", "bt"):
            raise ValueError(f"unknown policy {req.policy!r}")
        if req.transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {req.transport!r}")
        if req.transport != "ecsq" and req.policy != "lossless":
            # block transports fix the rate by wire width and ignore the
            # controller's bin size: an ECSQ rate policy would be silently
            # unenforced (and its rate accounting fiction)
            raise ValueError(
                f"policy={req.policy!r} has no effect under "
                f"transport={req.transport!r}; use policy='lossless'")
        if req.layout not in (None, "row", "col"):
            raise ValueError(f"unknown layout {req.layout!r}")
        if not 0.0 <= req.erasure_rate < 1.0:
            raise ValueError(f"erasure_rate {req.erasure_rate} not in [0, 1)")
        if req.erasure_model not in ("bernoulli", "gilbert"):
            raise ValueError(f"unknown erasure_model {req.erasure_model!r}")
        if req.recovery not in ("retransmit", "rate_up"):
            raise ValueError(f"unknown recovery {req.recovery!r}")
        if req.layout is None:
            # pin the auto-routed layout on our copy (never on the caller's
            # template, which another policy may route differently)
            req = dataclasses.replace(
                req, layout=placement_for(req.n, req.m, req.n_proc,
                                          self.n_devices, self.policy)[1])
        if req.layout == "col" and req.n % req.n_proc:
            raise ValueError(
                f"N={req.n} not divisible by P={req.n_proc} (column layout)")
        if req.layout == "row" and req.m % req.n_proc:
            raise ValueError(f"M={req.m} not divisible by P={req.n_proc}")
        if req.policy == "fixed" and (req.deltas is None
                                      or len(req.deltas) != req.n_iter):
            raise ValueError("the fixed policy needs n_iter deltas")
        if req.policy == "dp" and req.deltas is None:
            req = dataclasses.replace(req, deltas=self._dp_deltas(req))
        return req

    def _key_for(self, req: SolveRequest) -> BucketKey:
        placement, _ = placement_for(req.n, req.m, req.n_proc,
                                     self.n_devices, self.policy)
        return bucket_for(req.n, req.m, req.n_proc, req.n_iter,
                          req.transport, self.policy, placement, req.layout)

    def _engine(self, key: BucketKey, wire: bool = False) -> AmpEngine:
        cache = self._wire_engines if wire else self._engines
        ekey = _engine_key(key)
        with self._lock:
            eng = cache.get(ekey)
            if eng is None:
                eng = cache[ekey] = _bucket_engine(
                    key, wire, self.collect_xs, self.device)
        return eng

    def _single_engine(self, req: SolveRequest) -> AmpEngine:
        """True-dims plain engine for the singleton fast path, keyed on
        everything its solve depends on (the prior lives on the engine
        here, unlike the het path where it rides as an operand)."""
        skey = (req.n, req.m, req.n_proc, req.n_iter, req.transport,
                req.prior)
        with self._lock:
            eng = self._single_engines.get(skey)
            if eng is None:
                cfg = EngineConfig(
                    n_proc=req.n_proc, n_iter=req.n_iter,
                    collect_symbols=False, collect_xs=self.collect_xs,
                    device=str(self.device))
                eng = AmpEngine(req.prior, cfg, _TRANSPORTS[req.transport]())
                self._single_engines[skey] = eng
        return eng

    def _dp_deltas(self, req: SolveRequest) -> np.ndarray:
        """Offline DP allocation realized as ECSQ bin sizes (DPSchedule /
        ColDPSchedule for column requests).

        Under erasure the allocators plan for the request's recovery
        policy; the realized bins then encode the *delivered* per-survivor
        rates (allocated * survivor boost), which is what the quantizers
        on the surviving packets spend."""
        prob = req.problem()
        r_total = (req.dp_total_bits if req.dp_total_bits is not None
                   else 2.0 * req.n_iter)
        _, boost, _ = erasure_rate_factors(req.erasure_rate, req.recovery)
        if req.layout == "col":
            dp = dp_allocate_col(prob, req.n_proc, req.n_iter, r_total,
                                 erasure_rate=req.erasure_rate,
                                 recovery=req.recovery)
            if boost != 1.0:
                dp = dataclasses.replace(dp, rates=dp.rates * boost)
            return ColDPSchedule(dp, prob, req.n_proc).deltas
        rd = self._rd_cache.get(req.prior)
        if rd is None:
            rd = self._rd_cache[req.prior] = RDModel(req.prior)
        dp = dp_allocate(prob, req.n_proc, req.n_iter, r_total, rd=rd,
                         erasure_rate=req.erasure_rate,
                         recovery=req.recovery)
        if boost != 1.0:
            dp = dataclasses.replace(dp, rates=dp.rates * boost)
        return DPSchedule(dp, rd, req.n_proc).deltas

    def _bt_tables(self, req: SolveRequest, t_max: int):
        """Padded BT tables for one operating point on the service's
        device, memoized per (operating point, t_max). Column requests get
        ``ColumnBTRateControl`` tables."""
        key = (req.prior, round(req.snr_db, 6), req.n, req.m, req.n_proc,
               req.n_iter, req.bt_c_ratio, req.bt_r_max, req.layout,
               req.erasure_rate, req.recovery)
        padded = self._bt_cache.get((key, t_max))
        if padded is None:
            ctrl = self._bt_cache.get(key)
            if ctrl is None:
                if req.layout == "col":
                    ctrl = ColumnBTRateControl(
                        req.problem(), req.n_proc, req.n_iter,
                        req.bt_c_ratio, req.bt_r_max,
                        erasure_rate=req.erasure_rate,
                        recovery=req.recovery)
                else:
                    ctrl = BTRateControl(req.problem(), req.n_proc,
                                         req.n_iter, req.bt_c_ratio,
                                         req.bt_r_max, "ecsq",
                                         erasure_rate=req.erasure_rate,
                                         recovery=req.recovery)
                self._bt_cache[key] = ctrl
            padded = pad_bt_tables(ctrl.tables, t_max).to(self.device)
            self._bt_cache[(key, t_max)] = padded
        return padded

    def _dummy(self, layout: str, t_max: int):
        """Benign tables for the non-BT instances of a batch with a BT
        request, on the device, one set per (layout, t_max)."""
        tb = self._dummy_tables.get((layout, t_max))
        if tb is None:
            cls = ColBTTables if layout == "col" else BTTables
            tb = self._dummy_tables[(layout, t_max)] = \
                cls.dummy(t_max).to(self.device)
        return tb

    def _drop_mask(self, req: SolveRequest,
                   n_proc: int | None = None) -> np.ndarray | None:
        """The (n_iter, P) erasure mask of one request, or None when the
        link is lossless. Deterministic in the request's erasure fields,
        so dispatch (operand build) and result finalization (retransmit
        byte accounting) independently draw the same mask. On the
        processor-sharded placement the mask's axis is the mesh's ranks
        (``n_proc`` = D)."""
        if req.erasure_rate == 0.0:
            return None
        spec = ErasureSpec(rate=req.erasure_rate, model=req.erasure_model,
                           burst_len=req.erasure_burst,
                           seed=req.erasure_seed)
        return spec.sample_mask(req.n_iter, n_proc or req.n_proc)

    def _fingerprint(self, req: SolveRequest):
        """Operand-cache identity of a request's A: the caller-vouched
        ``a_id`` when set, else the content hash (in-place mutation of a
        caller's array is then a miss, never a stale hit)."""
        return req.a_id if req.a_id is not None else fingerprint(req.a)

    def _pad_a_one(self, key: BucketKey, r: SolveRequest) -> np.ndarray:
        """Host-side pad of one request's A into its bucket shard shape:
        (P, mp_pad, n_pad) row / (P, m_pad, np_pad) col, each processor's
        real rows (row) or columns (col) at the head of its own shard."""
        p, mp_pad, n_pad = key.n_proc, key.mp_pad, key.n_pad
        if key.layout == "col":
            buf = np.zeros((p, mp_pad, n_pad // p), np.float32)
            buf[:, :r.m, :r.n // p] = split_problem_cols(
                np.asarray(r.a, np.float32), p)
        else:
            mp = r.m // p
            buf = np.zeros((p, mp_pad, n_pad), np.float32)
            buf[:, :mp, :r.n] = np.asarray(r.a, np.float32).reshape(
                p, mp, r.n)
        return buf

    def _upload_a(self, eng: AmpEngine, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device,
                                      dtype=eng.cfg.a_tdtype)

    def _a_key(self, key: BucketKey, r: SolveRequest, a_dtype: str) -> tuple:
        """The operand-cache key of one request's padded A shards (every
        rank of a mesh keys its own shards alike)."""
        return (key.layout, self._fingerprint(r), key.n_proc, key.mp_pad,
                key.n_pad, a_dtype)

    def _a_slice(self, key: BucketKey, r: SolveRequest, eng: AmpEngine,
                 ck: tuple | None = None):
        """Device-resident padded A shards for one request: built (pad +
        dtype cast + copy to the device) once per (fingerprint, bucket
        shard shape) and reused across batches and streams. On the
        processor-sharded placement, rank 0's own P / D shards only.
        ``ck``: the request's ``_a_key``, when the caller has it (the
        fingerprint hashes all of A)."""
        ck = self._a_key(key, r, eng.cfg.a_dtype) if ck is None else ck
        pad = lambda: self._pad_a_one(key, r)
        if key.placement == "proc":
            ck = ck + ("proc", 0, self.n_devices)
            pad = lambda: rank_slice(self._pad_a_one(key, r), 0,
                                     self.n_devices)
        build = lambda: self._upload_a(eng, np.ascontiguousarray(pad()))
        if self._opcache is None:
            return build()
        return self._opcache.get(ck, build)

    def _a_batch(self, key: BucketKey, batch: list, eng: AmpEngine,
                 use_cache: bool = True):
        """Batch A operand: a stack on the device over cache-resident
        shards (a pad slot repeating a real request hits the same entry),
        or a host-assembled block when the cache is off — including
        prewarm, whose all-zero dummies must not pollute it."""
        if self._opcache is not None and use_cache:
            return torch.stack([self._a_slice(key, r, eng) for r in batch])
        return self._upload_a(eng, np.stack([self._pad_a_one(key, r)
                                             for r in batch]))

    def _y_and_params(self, key: BucketKey, batch: list):
        """Per-flush (small) operands: padded y and the per-instance
        ``HetParams``, built on the host and copied to the device; the BT
        tables are stacked on the device from their cached sets."""
        p, mp_pad, t_max = key.n_proc, key.mp_pad, key.t_max
        b = len(batch)
        is_col = key.layout == "col"
        if is_col:
            y_b = np.zeros((b, mp_pad), np.float32)
        else:
            y_b = np.zeros((b, p, mp_pad), np.float32)
        scheds, tacts, mreals, nreals = [], [], [], []
        eps, mus, sss, use_bt = [], [], [], []
        for i, r in enumerate(batch):
            if is_col:
                y_b[i, :r.m] = np.asarray(r.y, np.float32)
            else:
                mp = r.m // p
                y_b[i, :, :mp] = np.asarray(r.y, np.float32).reshape(p, mp)
            if r.policy in ("fixed", "dp"):
                scheds.append(np.asarray(r.deltas, np.float32))
            else:  # lossless / bt: schedule operand unused or all-lossless
                scheds.append(np.full(r.n_iter, np.inf, np.float32))
            tacts.append(r.n_iter)
            mreals.append(r.m)
            nreals.append(r.n)
            eps.append(r.prior.eps)
            mus.append(r.prior.mu_s)
            sss.append(r.prior.sigma_s)
            use_bt.append(r.policy == "bt")
        has_bt = any(use_bt)
        if has_bt:
            tables = stack_bt_tables([
                self._bt_tables(r, t_max) if r.policy == "bt"
                else self._dummy(key.layout, t_max) for r in batch])
        else:
            # no instance decides by BT: the engine runs no controller, the
            # tables are never read
            tables = self._dummy(key.layout, t_max)
        # the erasure masks ride as a (B, T, P) operand only when some
        # request of the batch loses packets (drop=None keeps the drop-free
        # code); a lossless request of such a batch gets zeros, an exact
        # no-op through the survivor rescale and the column reset
        drops = None
        if any(r.erasure_rate > 0.0 for r in batch):
            p_mask = self.n_devices if key.placement == "proc" else p
            drops = np.zeros((b, t_max, p_mask), np.float32)
            for i, r in enumerate(batch):
                mask = self._drop_mask(r, p_mask)
                if mask is not None:
                    drops[i, :r.n_iter] = mask
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))
        params = HetParams(
            sched=torch.from_numpy(stack_schedules(scheds, t_max)),
            t_active=torch.as_tensor(tacts, dtype=torch.int64),
            m_real=f32(mreals), n_real=torch.as_tensor(nreals,
                                                       dtype=torch.int64),
            eps=f32(eps), mu_s=f32(mus), sigma_s=f32(sss),
            use_bt=torch.as_tensor(use_bt), bt=tables,
            drop=None if drops is None else torch.from_numpy(drops))
        return torch.from_numpy(y_b), params.to(self.device), has_bt

    def _het_operands(self, key: BucketKey, batch: list,
                      use_cache: bool = True):
        """Pad one request group into the engine's het operands.

        Row buckets: a (B, P, mp_pad, n_pad) row shards + y (B, P, mp_pad).
        Column buckets: a (B, P, m_pad, np_pad) column shards + the shared
        y (B, m_pad).
        """
        a_b = self._a_batch(key, batch, self._engine(key), use_cache)
        y_b, params, has_bt = self._y_and_params(key, batch)
        return a_b, y_b, params, has_bt

    def _dispatch_bucket(self, key: BucketKey, reqs: list) -> _Pending:
        """Launch one bucket group on its placement; bringing results to
        the host is deferred to the returned ``_Pending`` (on a mesh the
        command runs to its end here, the workers' results gathered)."""
        if key.placement == "proc":
            return self._dispatch_proc(key, reqs)
        if key.placement == "data":
            return self._dispatch_data(key, reqs)
        if len(reqs) == 1 and self._singleton_ok(key, reqs[0]):
            return self._dispatch_singleton(key, reqs[0])

        b_real = len(reqs)
        b_pad = pad_batch_size(b_real, self.policy)
        # fill pad slots by repeating real requests (their results are
        # dropped); keeps every instance numerically benign, and a pad
        # slot is an operand-cache hit, not a rebuild
        batch = [reqs[i % b_real] for i in range(b_pad)]
        # a measured-wire request anywhere in the group routes the whole
        # batch onto the symbol-tracing engine twin (same math, bigger
        # trace)
        wire = any(r.measure_wire for r in reqs)
        eng = self._engine(key, wire)
        t_op0 = _tnow() if self.telemetry else 0.0
        a_b = self._a_batch(key, batch, eng)
        y_b, params, has_bt = self._y_and_params(key, batch)
        t_c0 = _tnow() if self.telemetry else 0.0
        x_outs = eng.dispatch_het(a_b, y_b, params, has_bt=has_bt)

        def finalize() -> list[SolveResult]:
            trace = eng.trace_of(x_outs)
            shared = self._batch_spans(t_op0, t_c0)
            if not self.telemetry or wire:
                # measured-wire groups keep the per-request tail (their
                # wire_measure span interleaves result assembly); with
                # telemetry off there is no tail at all
                return [self._result_one(key, r, trace, i, b_real,
                                         shared_spans=shared)
                        for i, r in enumerate(reqs)]
            t_fin0 = _tnow()
            out = [self._result_one(key, r, trace, i, b_real, defer=True)
                   for i, r in enumerate(reqs)]
            self._batch_tail(key, reqs, out, shared, trace, t_fin0)
            return out

        return finalize

    # -- the mesh placements (rank 0's side of the worker protocol) ---------

    def _command(self, header: dict, a_for, own, check=None):
        """Run one mesh command: broadcast ``header``; rank 0 runs
        ``check()`` (its operands' checks) while each worker prepares (its
        engine, the same checks of the operands, the A shards it lacks);
        gather every rank's ``(ok, missing keys or traceback)``; build the
        shards to send (``a_for(rank, key)``, a host array); broadcast
        whether all of that succeeded; send each worker its shards, run
        ``own()`` (rank 0's part) and gather every rank's ``(ok, result)``.

        A failure up to the go round (a malformed command, a shard that
        cannot be built) ends the command on every rank, and rank 0 raises
        with the failing ranks' tracebacks. A failure after it, inside a
        send or a solve's collectives (out of memory mid-solve), leaves the
        other ranks waiting in a collective: that ends in the process
        group's timeout (``init_cluster``). Returns ``(own's result, the
        workers' results)``."""
        mesh = self.mesh
        broadcast_object(header, mesh)
        try:
            if check is not None:
                check()
            mine = (True, [])
        except Exception:
            mine = (False, traceback.format_exc())
        ready = gather_object(mine, mesh)
        errors = [f"rank {r}: {msg}" for r, (ok, msg) in enumerate(ready)
                  if not ok]
        shards = []
        if not errors:
            try:
                shards = [(rank, np.ascontiguousarray(a_for(rank, ck),
                                                      np.float32))
                          for rank, (_, missing) in enumerate(ready)
                          for ck in missing]
            except Exception:
                errors.append(f"rank 0: {traceback.format_exc()}")
        go = not errors
        broadcast_object(go, mesh)
        mine, err = None, None
        if go:
            try:
                for rank, a in shards:
                    send_tensor(torch.from_numpy(a).to(
                        mesh.device if mesh.backend == "nccl" else "cpu"),
                        rank, mesh)
                mine = own()
            except Exception:
                err = traceback.format_exc()
        done = gather_object((err is None, err), mesh)
        errors += [f"rank {r}: {msg}" for r, (ok, msg) in enumerate(done)
                   if not ok and msg]
        if errors:
            raise RuntimeError("mesh command failed:\n" + "\n".join(errors))
        return mine, [msg for _, msg in done[1:]]

    def _dispatch_data(self, key: BucketKey, reqs: list,
                       zeros: bool = False) -> _Pending:
        """Data-parallel placement: the padded batch, rounded up to a
        multiple of D, is cut into D slices of B / D instances; rank r
        solves slice r with its own ``dispatch_het`` (A from its operand
        cache) and rank 0 gathers the traces. ``zeros`` (prewarm): zero
        operands, built on each rank, no cache."""
        d = self.n_devices
        b_real = len(reqs)
        b_pad = round_up(pad_batch_size(b_real, self.policy), d)
        batch = [reqs[i % b_real] for i in range(b_pad)]
        per = b_pad // d
        wire = any(r.measure_wire for r in reqs)
        eng = self._engine(key, wire)
        t_op0 = _tnow() if self.telemetry else 0.0
        y_b, params, has_bt = self._y_and_params(key, batch)
        y_host = y_b.numpy()
        # one fingerprint a request (a pad slot repeats a real request)
        by_req = {id(r): self._a_key(key, r, eng.cfg.a_dtype) for r in reqs}
        a_keys = [by_req[id(r)] for r in batch]
        pads = dict(zip(a_keys, batch))
        header = {"op": "het", "key": key, "wire": wire,
                  "collect_xs": self.collect_xs, "has_bt": has_bt,
                  "zeros": zeros, "items": [
                      {"a_keys": a_keys[r * per:(r + 1) * per],
                       "y": y_host[r * per:(r + 1) * per],
                       "params": _params_arrays(_instances(
                           params, slice(r * per, (r + 1) * per), has_bt))}
                      for r in range(d)]}

        def own():
            sl = slice(0, per)
            if zeros:
                a_b = self._het_operands(key, batch[sl], use_cache=False)[0]
            else:
                a_b = torch.stack([self._a_slice(key, r, eng, ck)
                                   for r, ck in zip(batch[sl], a_keys[sl])])
            t_c = _tnow() if self.telemetry else 0.0
            x_outs = eng.dispatch_het(a_b, y_b[sl].to(self.device),
                                      _instances(params, sl, has_bt),
                                      has_bt=has_bt)
            return t_c, eng.trace_of(x_outs)

        (t_c0, trace0), rest = self._command(
            header, lambda rank, ck: self._pad_a_one(key, pads[ck]), own)
        trace = _concat_traces([trace0, *rest])

        def finalize() -> list[SolveResult]:
            shared = self._batch_spans(t_op0, t_c0)
            return [self._result_one(key, r, trace, i, b_real,
                                     shared_spans=shared)
                    for i, r in enumerate(reqs)]

        return finalize

    def _dispatch_proc(self, key: BucketKey, reqs: list,
                       zeros: bool = False) -> _Pending:
        """Processor-sharded placement: each request owns the whole mesh
        for one ``dispatch_sharded`` on every rank (still padded to the
        bucket shape); each rank's P / D shards of A ride in its operand
        cache. ``zeros`` (prewarm): zero operands, no cache."""
        eng = self._engine(key)
        done = []
        for r in reqs:
            if r.measure_wire:
                raise ValueError(
                    "measure_wire is unsupported on the processor-sharded "
                    "placement (symbols stay per rank); pin layout/shape "
                    "to a local or data-parallel bucket")
            t_op0 = _tnow() if self.telemetry else 0.0
            (t_c0, trace), _ = self._command(
                *self._proc_command(key, eng, r, zeros))
            done.append((r, trace, t_op0, t_c0))

        def finalize() -> list[SolveResult]:
            return [self._result_one(key, r, trace, None, 1,
                                     shared_spans=self._batch_spans(
                                         t_op0, t_c0))
                    for r, trace, t_op0, t_c0 in done]

        return finalize

    def _proc_command(self, key: BucketKey, eng: AmpEngine,
                      r: SolveRequest, zeros: bool):
        """One processor-sharded request as ``_command``'s arguments:
        ``(header, a_for, own, check)``."""
        d = self.n_devices
        y_b, params, has_bt = self._y_and_params(key, [r])
        hp = _instances(params, 0, has_bt)
        ck = self._a_key(key, r, eng.cfg.a_dtype)
        shard = (key.n_proc // d,) + self._a_tail(key)
        header = {"op": "proc", "key": key, "has_bt": has_bt,
                  "collect_xs": self.collect_xs, "zeros": zeros,
                  "a_key": ck, "y": y_b[0].numpy(),
                  "params": _params_arrays(hp)}

        def own():
            a_own = (torch.zeros(shard, dtype=eng.cfg.a_tdtype,
                                 device=self.device)
                     if zeros else self._a_slice(key, r, eng, ck))
            t_c = _tnow() if self.telemetry else 0.0
            x_outs = eng.dispatch_sharded(a_own, y_b[0], hp, self.mesh,
                                          has_bt=has_bt)
            return t_c, eng.trace_of(x_outs)

        return (header,
                lambda rank, _ck: rank_slice(self._pad_a_one(key, r), rank,
                                             d),
                own,
                lambda: eng.check_sharded(shard, tuple(y_b[0].shape), hp,
                                          self.mesh))

    @staticmethod
    def _a_tail(key: BucketKey) -> tuple:
        """A processor's padded shard shape in a bucket."""
        if key.layout == "col":
            return (key.mp_pad, key.n_pad // key.n_proc)
        return (key.mp_pad, key.n_pad)

    def close(self) -> None:
        """Stop the mesh's workers (``serve_mesh_worker`` returns on every
        other rank; services sharing a mesh share its workers, so one of
        them closes). Without a mesh, nothing to do."""
        if self.mesh is not None and self.n_devices > 1:
            broadcast_object({"op": "stop"}, self.mesh)
            gather_object((True, None), self.mesh)
            self.mesh = None

    def _layout_children(self, layout: str) -> dict:
        """Label-bound metric handles for one layout, resolved once."""
        ch = self._children.get(layout)
        if ch is None:
            ch = self._children[layout] = {
                "requests": self._m_requests.labels(layout=layout),
                "latency": self._h_latency.labels(layout=layout),
                "batch_wait": self._h_batch_wait.labels(layout=layout),
                "drift": self._h_drift.labels(layout=layout),
                "alerts": self._m_drift_alerts.labels(layout=layout),
            }
        return ch

    def _batch_tail(self, key: BucketKey, reqs: list, results: list,
                    shared: list, trace, t_fin0: float) -> None:
        """Telemetry tail for one batched group in a single pass: spans per
        request with the operands/compute/complete spans shared verbatim
        (the batch is the unit of execution), the drift-path uniformity
        check folded into the same loop, histograms fed by one bulk observe
        per metric."""
        ch = self._layout_children(key.layout)
        t_end = _tnow()
        sh0 = shared[0][2]
        op_s, cp_s = shared
        co_s = ["complete", None, t_fin0, t_end]
        lats: list = []
        waits: list = []
        lat_add, wait_add = lats.append, waits.append
        r0 = reqs[0]
        v0 = _DRIFT_ATTRS(r0)
        p0 = r0.prior
        uniform = True
        for r, res in zip(reqs, results):
            rs = r.spans
            if rs:
                t_a = rs[-1][3]
                spans = [*rs, ["batch_wait", None, t_a, sh0],
                         op_s, cp_s, co_s]
                if rs[0][0] == "admit":
                    lat_add(t_end - rs[0][2])
            else:
                # local request: submit stashed only the admit timestamp
                t_a = getattr(r, "_t_admit", sh0)
                spans = [["admit", None, t_a, t_a],
                         ["batch_wait", None, t_a, sh0], op_s, cp_s, co_s]
                lat_add(t_end - t_a)
            res.spans = spans
            wait_add(sh0 - t_a)
            if uniform and not (r.prior is p0 and _DRIFT_ATTRS(r) == v0):
                uniform = False
        ch["requests"].inc(len(reqs))
        if lats:
            ch["latency"].observe_many(lats)
        ch["batch_wait"].observe_many(waits)
        self._drift_tail(key, reqs, results, trace, uniform, ch)

    def _drift_tail(self, key: BucketKey, reqs: list, results: list,
                    trace, uniform: bool, ch: dict) -> None:
        """SE drift for a whole bucket group, written onto the built
        results: one vectorized pass for a group uniform in operating
        point, the per-request memoized path otherwise."""
        layout = "col" if key.layout == "col" else "row"
        r0 = reqs[0]
        dr: list = []
        dr_add = dr.append
        isfin = math.isfinite
        try:
            if uniform:
                t = r0.n_iter
                s2 = np.asarray(trace.sigma2_hat)[:len(reqs), :t]
                ev = np.asarray(trace.extra_var)[:len(reqs), :t]
                sched = ev[0] if np.array_equiv(ev[:1], ev) else ev
                drifts = se_drift_batch(
                    r0.problem(), s2, sched, layout=layout,
                    n_proc=r0.n_proc, erasure_rate=r0.erasure_rate)
                for res, d in zip(results, drifts.tolist()):
                    if isfin(d):
                        res.se_drift = d
                        dr_add(d)
            else:
                s2_all = np.asarray(trace.sigma2_hat)
                ev_all = np.asarray(trace.extra_var)
                for i, (r, res) in enumerate(zip(reqs, results)):
                    try:
                        d, _ = se_drift(r.problem(), s2_all[i, :r.n_iter],
                                        ev_all[i, :r.n_iter], layout=layout,
                                        n_proc=r.n_proc,
                                        erasure_rate=r.erasure_rate)
                    except Exception:   # advisory: never fails a solve
                        continue
                    if isfin(d):
                        res.se_drift = d
                        dr_add(d)
        except Exception:
            # the monitor is advisory: a drift failure never fails a solve
            return
        if dr:
            ch["drift"].observe_many(dr)
            n_alert = sum(1 for d in dr if d > DRIFT_ALERT)
            if n_alert:
                ch["alerts"].inc(n_alert)

    def _batch_spans(self, t_op0: float, t_c0: float) -> list | None:
        """Batch-level spans stamped at finalize time: operand build/upload
        (t_op0 -> dispatch) and device compute (dispatch -> trace on the
        host). Shared verbatim by every request in the batch."""
        if not self.telemetry:
            return None
        t_done = _tnow()
        return [_tspan("operands", t_op0, t_c0),
                _tspan("compute", t_c0, t_done)]

    def _singleton_ok(self, key: BucketKey, r: SolveRequest) -> bool:
        """Whether a lone request may skip batch padding and het-operand
        assembly and run the plain true-dims ``dispatch_single`` solve. BT
        stays on the het path (its controller is the per-instance table
        machinery), column requests stay batched (no plain single-dispatch
        entry point) and so do erasure and measured-wire requests (drop
        operands and symbol tracing are het-path machinery)."""
        return (self.singleton_fastpath and key.layout == "row"
                and r.policy != "bt" and r.erasure_rate == 0.0
                and not r.measure_wire)

    def _dispatch_singleton(self, key: BucketKey, r: SolveRequest) \
            -> _Pending:
        """Singleton fast path: true-dims solve on a plain engine, A from
        the operand cache, the schedule riding as the ``sched`` operand."""
        eng = self._single_engine(r)
        with self._lock:
            self._singleton_dispatches += 1
        t_op0 = _tnow() if self.telemetry else 0.0
        ck = ("single", self._fingerprint(r), r.n_proc, eng.cfg.a_dtype)
        build = lambda: eng._split(np.zeros(r.m, np.float32), r.a)[0]
        a_p = build() if self._opcache is None \
            else self._opcache.get(ck, build)
        p = r.n_proc
        y_p = np.asarray(r.y, np.float32).reshape(p, r.m // p)
        if r.policy in ("fixed", "dp"):
            sched = np.asarray(r.deltas, np.float32)
        else:
            sched = np.full(r.n_iter, np.inf, np.float32)
        t_c0 = _tnow() if self.telemetry else 0.0
        x_outs = eng.dispatch_single(a_p, y_p, r.m, r.n, sched=sched)

        def finalize() -> list[SolveResult]:
            trace = eng.trace_of(x_outs)
            return [self._result_one(key, r, trace, None, 1,
                                     shared_spans=self._batch_spans(
                                         t_op0, t_c0))]

        return finalize

    def _result_one(self, key: BucketKey, r: SolveRequest, trace,
                    i: int | None, batch_size: int,
                    shared_spans: list | None = None,
                    drift=_COMPUTE, defer: bool = False) -> SolveResult:
        """Unpad one request's slice of a trace (``i=None``: an unbatched
        trace). ``defer=True`` (the batched path) skips the per-request
        telemetry tail: ``_batch_tail`` does it for the whole group."""
        t_fin0 = _tnow() if self.telemetry and not defer else 0.0
        t = r.n_iter
        sel = (lambda a: a[:t]) if i is None else (lambda a: a[i, :t])
        x_pad = trace.x if i is None else trace.x[i]
        if key.layout == "col":
            # per-slice column padding: real columns are the leading n/P
            # entries of each processor's slice
            p = key.n_proc
            x = x_pad.reshape(p, key.n_pad // p)[:, :r.n // p].reshape(-1)
        else:
            x = x_pad[:r.n]
        s2 = sel(trace.sigma2_hat)
        deltas = sel(trace.deltas)
        extra_var = sel(trace.extra_var)
        rates = self._rates(r, s2, deltas, sel(trace.rates), extra_var)
        finite = np.isfinite(rates)
        wire = None
        wire_span = None
        if r.measure_wire and trace.symbols is not None:
            syms = trace.symbols if i is None else trace.symbols[i]
            # payload = length-N messages (row) / length-M residual
            # contributions (col); padding quantizes zeros
            n_elem = r.m if key.layout == "col" else r.n
            t_w0 = _tnow() if self.telemetry else 0.0
            wire = measure_wire(syms[:t, :, :n_elem], deltas, n_elem,
                                drop=self._drop_mask(r), recovery=r.recovery,
                                model=self.wire_model)
            if self.telemetry:
                wire_span = _tspan("wire_measure", t_w0)
        if defer:
            drift, spans = None, None
        else:
            drift, spans = self._finish_telemetry(
                key, r, s2, extra_var, t_fin0, shared_spans, wire_span,
                drift=drift)
        return SolveResult(
            request_id=r.request_id,
            x=x.copy(),
            sigma2_hat=s2.copy(), deltas=deltas.copy(),
            extra_var=extra_var.copy(), rates=rates,
            total_bits=float(rates[finite].sum()),
            bucket=key, batch_size=batch_size,
            bytes_on_wire=None if wire is None else wire["bytes_on_wire"],
            payload_bytes=None if wire is None else wire["payload_bytes"],
            time_on_air_s=None if wire is None else wire["time_on_air_s"],
            energy_j=None if wire is None else wire["energy_j"],
            se_drift=drift, spans=spans,
        )

    def _finish_telemetry(self, key: BucketKey, r: SolveRequest, s2,
                          extra_var, t_fin0: float,
                          shared_spans: list | None,
                          wire_span: list | None, drift=_COMPUTE):
        """Per-request telemetry tail for the singleton and measured-wire
        paths: SE drift against the operating point's prediction plus span
        assembly and the latency/drift histograms."""
        if not self.telemetry:
            return None, None
        ch = self._layout_children(key.layout)
        ch["requests"].inc()
        if drift is _COMPUTE:
            try:
                drift, _ = se_drift(
                    r.problem(), s2, extra_var,
                    layout="col" if key.layout == "col" else "row",
                    n_proc=r.n_proc, erasure_rate=r.erasure_rate)
            except Exception:
                # advisory: a drift failure never fails the solve
                drift = None
            if drift is not None and not math.isfinite(drift):
                drift = None
        if drift is not None:
            ch["drift"].observe(drift)
            if drift > DRIFT_ALERT:
                ch["alerts"].inc()
        spans = list(r.spans or [])
        if not spans:
            t_a = getattr(r, "_t_admit", None)
            if t_a is not None:
                spans = [["admit", None, t_a, t_a]]
        if shared_spans:
            t_admit_end = spans[-1][3] if spans else shared_spans[0][2]
            spans.append(["batch_wait", None, t_admit_end,
                          shared_spans[0][2]])
            spans.extend(shared_spans)
            ch["batch_wait"].observe(shared_spans[0][2] - t_admit_end)
        if wire_span is not None:
            spans.append(wire_span)
        t_tail0 = wire_span[3] if wire_span is not None else t_fin0
        t_end = _tnow()
        spans.append(["complete", None, t_tail0, t_end])
        if spans and spans[0][0] == "admit":
            ch["latency"].observe(t_end - spans[0][2])
        return drift, spans

    def _rates(self, req: SolveRequest, s2, deltas, bt_rates,
               extra_var) -> np.ndarray:
        """Realized-rate accounting for one request (see SolveResult).

        Column requests model the quantized payload as the residual
        contribution's Gaussian (``residual_mixture``): the payload of
        round t is built from the estimate after round t-1, whose block MSE
        reads off *this* round's plug-in, d^{t-1} = kappa * (v_t -
        sigma_e^2 - P sigma_Q^2_t). Round 0 exchanges all-zero
        contributions — 0 bits at any bin size — and is counted as 0.0
        whenever the request is rate-tracked at all (a fully lossless
        request stays untracked, all-inf).

        Under erasure the reported rates are *on-the-wire*: the delivered
        model rate times the recovery policy's wire factor (retransmit
        re-sends dropped packets, rate_up's allocated slot rate is what
        each slot transmits), ``erasure_rate_factors``. Exactly the
        delivered rate on a lossless link."""
        rates = self._rates_delivered(req, s2, deltas, bt_rates, extra_var)
        if req.erasure_rate > 0.0:
            _, _, wire_f = erasure_rate_factors(req.erasure_rate,
                                                req.recovery)
            fin = np.isfinite(rates)
            rates = np.where(fin, rates * wire_f, rates)
        return rates

    def _rates_delivered(self, req: SolveRequest, s2, deltas, bt_rates,
                         extra_var) -> np.ndarray:
        if req.policy == "bt":
            return np.asarray(bt_rates, np.float64)
        if req.transport != "ecsq":
            # block transports spend a fixed wire rate every iteration:
            # `bits` per element plus a bf16 scale per block
            tp = _TRANSPORTS[req.transport]()
            rates = np.full(req.n_iter, tp.bits + 16.0 / tp.block)
            if req.layout == "col":
                rates[0] = 0.0   # zero contributions: nothing on the wire
            return rates
        rates = np.full(req.n_iter, np.inf)
        if not self.rate_accounting:
            return rates
        prob = req.problem() if req.layout == "col" else None
        sm = req.prior.second_moment
        for t in range(1 if req.layout == "col" else 0, req.n_iter):
            d = float(deltas[t])
            if not math.isfinite(d):
                continue
            if req.layout == "col":
                d_blk = prob.kappa * (float(s2[t]) - prob.sigma_e2
                                      - float(extra_var[t]))
                mix = residual_mixture(req.prior,
                                       min(max(d_blk, 1e-12), sm),
                                       prob.kappa, req.n_proc)
            else:
                mix = message_mixture(req.prior, float(s2[t]), req.n_proc)
            rates[t] = float(ecsq_entropy(d, mix)[0])
        if req.layout == "col" and np.isfinite(rates[1:]).any():
            rates[0] = 0.0
        return rates

    # -- prewarm + observability ----------------------------------------------

    def _spec_request(self, spec: PrewarmSpec) -> SolveRequest:
        """Dummy request with the spec's structural shape (zero operands:
        the programs depend on shapes, not values)."""
        deltas = (np.full(spec.n_iter, np.inf, np.float32)
                  if spec.policy == "fixed" else None)
        return SolveRequest(
            y=np.zeros(spec.m, np.float32),
            a=np.zeros((spec.m, spec.n), np.float32),
            prior=spec.prior, snr_db=spec.snr_db, n_proc=spec.n_proc,
            n_iter=spec.n_iter, policy=spec.policy, deltas=deltas,
            transport=spec.transport, layout=spec.layout)

    def prewarm(self, menu, background: bool = False):
        """Warm the bucket x batch-width grid of a traffic menu of
        ``PrewarmSpec``s: build the kernels of the menu's layouts (one
        ``nvcc`` each, all at once), the engines, the BT tables and DP
        schedules, and run every (bucket, width, BT or not) program once on
        zero operands, so that steady-state requests pay none of it.

        Blocking by default (returns the report dict); with
        ``background=True`` it runs on a daemon thread (returns the
        ``Thread``). The report is on ``stats()["prewarm"]`` either way.
        Dummy operands bypass the operand cache (zero-A entries would
        poison it)."""
        menu = list(menu)
        if background and self.n_devices > 1:
            # the mesh's commands run in one order on every rank: a second
            # thread issuing them would interleave with the foreground's
            raise ValueError("a mesh service prewarms in the foreground")
        if background:
            th = threading.Thread(target=self._prewarm_run, args=(menu,),
                                  name="solve-prewarm", daemon=True)
            self._prewarm_thread = th
            th.start()
            return th
        return self._prewarm_run(menu)

    def _prewarm_run(self, menu: list) -> dict:
        t0 = time.perf_counter()
        reqs = [self._prepare(self._spec_request(spec), assign_id=False)
                for spec in menu]
        if self.device.type == "cuda":
            from ..kernels.build import ensure_built
            ensure_built(sorted({src for r in reqs
                                 for src in _SOURCES[r.layout]}))
        programs, buckets = 0, set()
        for spec, req in zip(menu, reqs):
            key = self._key_for(req)
            buckets.add(str(key))
            eng = self._engine(key)
            if key.placement == "proc":
                # every rank runs the sharded program once, on zeros
                self._dispatch_proc(key, [req], zeros=True)
                programs += 1
                continue
            widths = spec.batch_widths
            if widths is None:
                widths = batch_width_ladder(
                    self.policy,
                    self.n_devices if key.placement == "data" else 1)
            for w in widths:
                w = pad_batch_size(min(int(w), self.policy.max_batch),
                                   self.policy)
                if key.placement == "data":
                    self._dispatch_data(key, [req] * round_up(
                        w, self.n_devices), zeros=True)
                    programs += 1
                    continue
                a_b, y_b, params, has_bt = self._het_operands(
                    key, [req] * w, use_cache=False)
                eng.dispatch_het(a_b, y_b, params, has_bt=has_bt)
                programs += 1
            if self._singleton_ok(key, req):
                seng = self._single_engine(req)
                a_p, y_p = seng._split(req.y, req.a)
                sched = (req.deltas if req.policy in ("fixed", "dp")
                         else np.full(req.n_iter, np.inf, np.float32))
                seng.dispatch_single(a_p, y_p, req.m, req.n, sched=sched)
                programs += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report = {"programs": programs, "buckets": sorted(buckets),
                  "seconds": time.perf_counter() - t0}
        self._prewarm_report = report
        return report

    def compile_count(self) -> int:
        """Distinct programs (entry point, operand shapes, BT or not) run
        across every engine this service owns (bucket engines, wire twins,
        singleton engines). Flat after ``prewarm`` under warmed traffic."""
        with self._lock:
            engines = (list(self._engines.values())
                       + list(self._wire_engines.values())
                       + list(self._single_engines.values()))
        return sum(e.counters()["compiles"] for e in engines)

    def _collect_metrics(self, reg: MetricsRegistry) -> None:
        """Snapshot-time collector: mirror the sources that keep their own
        counters into the registry (no hot-path writes)."""
        st = self.stats()
        comp = reg.counter("amp_engine_compiles_total",
                           "Distinct programs run per bucket engine",
                           ("bucket",))
        disp = reg.counter("amp_engine_dispatches_total",
                           "Engine dispatches per bucket", ("bucket",))
        for label, v in st["compiles"]["by_bucket"].items():
            comp.set_total(v, bucket=label)
        for label, v in st["dispatches"]["by_bucket"].items():
            disp.set_total(v, bucket=label)
        reg.counter("amp_singleton_dispatches_total",
                    "Singleton fast-path dispatches").set_total(
                        st["singleton_dispatches"])
        dem = reg.counter("amp_bucket_demand_total",
                          "Requests ever admitted per bucket", ("bucket",))
        for k, v in st["bucket_demand"].items():
            dem.set_total(v, bucket=k)
        oc = st["operand_cache"]
        if oc is not None:
            for name in ("hits", "misses", "evictions"):
                reg.counter(f"amp_operand_cache_{name}_total",
                            f"Operand cache {name}").set_total(oc[name])
            reg.gauge("amp_operand_cache_bytes",
                      "Operand cache resident bytes").set(oc["bytes"])
            reg.gauge("amp_operand_cache_entries",
                      "Operand cache entries").set(oc["entries"])

    def metrics(self) -> dict:
        """JSON-able metrics snapshot: event-driven request/latency/drift
        series plus the pulled engine/cache/demand counters. Empty when
        constructed with ``telemetry=False``."""
        if self._registry is None:
            return {"metrics": []}
        return self._registry.snapshot()

    def metrics_text(self) -> str:
        """``metrics()`` rendered as Prometheus text exposition format."""
        return prometheus_text(self.metrics())

    def demand(self) -> dict:
        """Lifetime per-bucket admission counts (``Batcher.demand``)."""
        return self._batcher.demand()

    def take_demand(self) -> dict:
        """Per-bucket admissions since the previous take
        (``Batcher.take_demand``)."""
        return self._batcher.take_demand()

    def stats(self) -> dict:
        """Hot-path observability: operand-cache counters, per-bucket
        program/dispatch counts, singleton fast-path traffic, per-bucket
        demand and the last prewarm report, read under the service lock
        from each engine's consistent ``counters()``."""
        with self._lock:
            engines = ([(k, e, "") for k, e in self._engines.items()]
                       + [(k, e, "/wire")
                          for k, e in self._wire_engines.items()])
            singles = list(self._single_engines.items())
            by_bucket = {}
            dispatches = {}
            for key, eng, tag in engines:
                label = (f"{key.layout}/{key.placement}/n{key.n_pad}"
                         f"/mp{key.mp_pad}/p{key.n_proc}/t{key.t_max}"
                         f"/{key.transport}{tag}")
                c = eng.counters()
                by_bucket[label] = c["compiles"]
                dispatches[label] = c["dispatches"]
            for (n, m, p, t, transport, _prior), eng in singles:
                label = f"single/n{n}/m{m}/p{p}/t{t}/{transport}"
                c = eng.counters()
                by_bucket[label] = c["compiles"]
                dispatches[label] = c["dispatches"]
            demand = self._batcher.demand()
            singleton_dispatches = self._singleton_dispatches
            prewarm_report = self._prewarm_report
            opstats = (self._opcache.stats()
                       if self._opcache is not None else None)
        return {
            "operand_cache": opstats,
            "compiles": {"total": sum(by_bucket.values()),
                         "by_bucket": by_bucket},
            "dispatches": {"total": sum(dispatches.values()),
                           "by_bucket": dispatches},
            "singleton_dispatches": singleton_dispatches,
            "bucket_demand": {str(k): v for k, v in demand.items()},
            "prewarm": prewarm_report,
        }


# -- the other ranks of a mesh -------------------------------------------------

def serve_mesh_worker(mesh, operand_cache_bytes: int = 256 << 20) -> dict:
    """The loop every rank but 0 of a serving mesh runs while rank 0's
    ``SolveService(mesh=mesh)`` serves: receive a command, take the A
    shards it lacks from rank 0 (kept in its own operand cache by the
    request's fingerprint), run its part (``dispatch_het`` of its slice of
    a data-parallel batch, or ``dispatch_sharded`` of a processor-sharded
    request) and report ``(ok, result)``. Returns, with a count of the
    commands it served, when rank 0's service is closed. A failure is
    reported to rank 0, which raises, and the loop goes on; the operands
    are checked before the go round, so a malformed command never starts a
    solve (``SolveService._command`` says which failures end in the
    group's timeout instead)."""
    cache = OperandCache(operand_cache_bytes)
    engines: dict = {}
    served = 0
    while True:
        cmd = broadcast_object(None, mesh)
        if cmd["op"] == "stop":
            gather_object((True, None), mesh)
            return {"commands": served, "operand_cache": cache.stats()}
        served += 1
        try:
            job = _worker_prepare(cmd, mesh, cache, engines)
            ready = (True, job["missing"])
        except Exception:
            job, ready = None, (False, traceback.format_exc())
        gather_object(ready, mesh)
        go = broadcast_object(None, mesh)
        if not go:
            gather_object((ready[0], None), mesh)
            continue
        try:
            result = _worker_run(cmd, job, mesh, cache)
            gather_object((True, result), mesh)
        except Exception:
            gather_object((False, traceback.format_exc()), mesh)


def _worker_prepare(cmd: dict, mesh, cache: OperandCache,
                    engines: dict) -> dict:
    """A worker's engine for the command, its operands (a processor-sharded
    one's checked as ``dispatch_sharded`` checks them) and the A shards it
    lacks."""
    key = cmd["key"]
    wire = cmd.get("wire", False)
    ekey = (_engine_key(key), wire, cmd["collect_xs"])
    eng = engines.get(ekey)
    if eng is None:
        eng = engines[ekey] = _bucket_engine(key, wire, cmd["collect_xs"],
                                             mesh.device)
    if cmd["op"] == "het":
        item = cmd["items"][mesh.rank]
        keys, y, params = item["a_keys"], item["y"], item["params"]
    else:
        keys = [cmd["a_key"] + ("proc", mesh.rank, mesh.size)]
        y, params = cmd["y"], cmd["params"]
    hp = convert.het_params_from_arrays(params, mesh.device)
    if cmd["op"] == "proc":
        eng.check_sharded((key.n_proc // mesh.size,)
                          + SolveService._a_tail(key), np.shape(y), hp, mesh)
    missing = [] if cmd["zeros"] else list(dict.fromkeys(
        k for k in keys if k not in cache))
    return {"eng": eng, "keys": keys, "missing": missing, "y": y, "hp": hp}


def _worker_run(cmd: dict, job: dict, mesh, cache: OperandCache):
    key, eng = cmd["key"], job["eng"]
    tail = SolveService._a_tail(key)
    lead = (key.n_proc // mesh.size if cmd["op"] == "proc"
            else key.n_proc,)
    got = {}
    for ck in job["missing"]:
        t = recv_tensor(lead + tail, torch.float32, 0, mesh)
        got[ck] = t.to(device=mesh.device, dtype=eng.cfg.a_tdtype)
    if cmd["zeros"]:
        shards = [torch.zeros(lead + tail, dtype=eng.cfg.a_tdtype,
                              device=mesh.device) for _ in job["keys"]]
    else:
        # hold every shard of the command before admitting the new ones,
        # so an eviction cannot take one this command still needs
        shards = [got[ck] if ck in got else cache.get(ck, None)
                  for ck in job["keys"]]
        for ck, t in got.items():
            cache.get(ck, lambda t=t: t)
    if cmd["op"] == "proc":
        eng.dispatch_sharded(shards[0], job["y"], job["hp"], mesh,
                             has_bt=cmd["has_bt"])
        return None
    return eng.trace_of(eng.dispatch_het(torch.stack(shards), job["y"],
                                         job["hp"], has_bt=cmd["has_bt"]))

