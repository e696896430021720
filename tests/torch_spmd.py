"""What the ranks of a gloo world run in the port's multi-device tests
(``test_torch_sharded.py``, ``test_torch_mesh_service.py``), and the plain
single-process emulation of ``compressed_psum`` they are held to.

This module imports the port only (no ``jax``, nothing of ``repro``): the
spawned ranks import it, and stay light. Inputs arrive as numpy arrays made
by the test from seeds; results go back as numpy arrays and ``EngineTrace``s.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.compression import (QuantConfig, compressed_psum,
                                          quant_noise_var)
from repro_torch.core.denoisers import BernoulliGauss
from repro_torch.core.engine import (AmpEngine, ColumnPartition,
                                     CompressedPsumTransport, EcsqTransport,
                                     EngineConfig, FixedSchedule, HetParams,
                                     PsumFusion)
from repro_torch.kernels.quantize import ops as qops
from repro_torch.launch.mesh import spawn_world
from repro_torch.launch.solver import DistributedMPAMP, SolverConfig

TIMEOUT_S = 300.0


def run_world(fn, world: int, tmp_path, *args):
    """``fn(mesh, *args)`` on ``world`` gloo ranks on the CPU (one thread
    each), joined through a FileStore under ``tmp_path``; each rank's
    result, by rank."""
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}")
    return spawn_world(fn, world, backend="gloo", device="cpu",
                       store_path=store, args=args, timeout_s=TIMEOUT_S,
                       threads=1)


def unbatch(hp: HetParams) -> HetParams:
    """The only instance of a B = 1 ``HetParams``, without its batch axis."""
    return hp._replace(
        sched=hp.sched[0], t_active=hp.t_active[0], m_real=hp.m_real[0],
        n_real=hp.n_real[0], eps=hp.eps[0], mu_s=hp.mu_s[0],
        sigma_s=hp.sigma_s[0], use_bt=hp.use_bt[0],
        bt=type(hp.bt)(*(v[0] for v in hp.bt)),
        drop=None if hp.drop is None else hp.drop[0])


def _engine(prior, p, t, transport, controller=None, layout=None):
    cfg = EngineConfig(n_proc=p, n_iter=t, collect_symbols=False,
                       device="cpu",
                       **({} if layout is None else {"layout": layout}))
    return AmpEngine(prior, cfg, transport, controller)


# -- the engine on a mesh (test_torch_sharded.py) -----------------------------

def engine_cases(mesh, data: dict) -> dict:
    """Every sharded engine solve of ``test_torch_sharded.py`` on this
    rank: the traces by case name."""
    prior = BernoulliGauss(eps=data["eps"])
    a, y, t = data["a"], data["y"], data["t"]
    d = mesh.size
    out = {}
    for p in data["row_ps"]:
        out[f"row_exact_P{p}"] = _engine(prior, p, t, PsumFusion()) \
            .solve_sharded(y, a, mesh)
    for p, n_inner in data["col_cases"]:
        out[f"col_exact_P{p}_i{n_inner}"] = _engine(
            prior, p, t, PsumFusion(), layout=ColumnPartition(n_inner)) \
            .solve_sharded(data["y_col"], data["a_col"], mesh)
    sched = FixedSchedule(data["deltas"])
    ecsq = lambda: _engine(prior, 24, t, PsumFusion(local=EcsqTransport()),
                           sched)
    out["ecsq"] = ecsq().solve_sharded(y, a, mesh)
    drop = np.zeros((t, d), np.float32)
    drop[3, :d // 2] = 1.0            # half the ranks out at iteration 3
    out["ecsq_drop"] = ecsq().solve_sharded(y, a, mesh, drop_sched=drop)
    out["exact_zero_drop"] = _engine(prior, 24, t, PsumFusion()) \
        .solve_sharded(y, a, mesh, drop_sched=np.zeros((t, d), np.float32))
    for bits in (8, 4):
        mesh.stats.reset()
        out[f"compressed{bits}"] = _engine(
            prior, 24, t, CompressedPsumTransport(bits=bits, block=256)) \
            .solve_sharded(y, a, mesh)
        out[f"compressed{bits}_stats"] = mesh.stats.snapshot()
    for key, (a_b, y_b, hp, col) in data["het"].items():
        eng = _engine(BernoulliGauss(), data["het_p"], data["het_t"],
                      PsumFusion(local=EcsqTransport()),
                      layout=ColumnPartition(1) if col else None)
        hp_t = unbatch(convert.het_params_from_arrays(hp))
        # every rank passes the whole padded instance, or (the service's
        # worker) only its own shards: the same trace
        out[f"het_{key}"] = eng.solve_sharded_het(a_b[0], y_b[0], hp_t, mesh)
        a_loc, y_loc = convert.rank_shards(a_b[0], y_b[0], mesh.rank, d,
                                           device="cpu", col=col)
        out[f"het_{key}_own_shard"] = eng.solve_sharded_het(a_loc, y_loc,
                                                            hp_t, mesh)
    return out


def solver_cases(mesh, data: dict) -> dict:
    """``DistributedMPAMP`` on this rank (P = the mesh size)."""
    prior = BernoulliGauss(eps=data["eps"])
    a, y, t = data["a"], data["y"], data["t"]
    out = {}
    for name, cfg in (("exact", SolverConfig(n_iter=t, bits=None)),
                      ("int8", SolverConfig(n_iter=t, bits=8)),
                      ("int4", SolverConfig(n_iter=t, bits=4)),
                      ("int8_drop", SolverConfig(n_iter=t, bits=8,
                                                 drop_rate=0.15))):
        out[name] = DistributedMPAMP(mesh, prior, cfg).solve(a, y, key=3)
    out["col_exact"] = DistributedMPAMP(
        mesh, prior, SolverConfig(n_iter=t, bits=None, layout="col")) \
        .solve(data["a_col"], data["y_col"])
    return out


def psum_cases(mesh, xs: np.ndarray, blocks) -> dict:
    """``compressed_psum`` of this rank's row of ``xs`` (D, L), int8 and
    int4 at each block size, with the bytes the mesh's collectives were
    handed."""
    x = torch.from_numpy(np.ascontiguousarray(xs[mesh.rank]))
    out = {}
    for bits in (8, 4):
        for block in blocks:
            mesh.stats.reset()
            s, noise = compressed_psum(x, mesh, QuantConfig(bits, block))
            out[(bits, block)] = (s.numpy(), float(noise),
                                  mesh.stats.snapshot())
    return out


def sharded_cases(mesh, data: dict) -> dict:
    """Everything ``test_torch_sharded.py`` runs on a rank, in one world:
    the engine's solves, ``DistributedMPAMP``'s and ``compressed_psum`` of
    each summand array in ``data["psum"]``."""
    return {"engine": engine_cases(mesh, data),
            "solver": solver_cases(mesh, {**data, "t": data["solver_t"]}),
            "psum": {length: psum_cases(mesh, xs[:mesh.size], (256, 512))
                     for length, xs in data["psum"].items()}}


# -- the plain emulation of compressed_psum ----------------------------------

def two_phases(x: torch.Tensor, qc: QuantConfig) -> dict:
    """The two phases of ``compressed_psum`` for D ranks in one process, on
    the stacked (D, L) summands: every rank's symbols and scales (``q1``,
    ``s1``: rank r's chunks for each destination), each rank's reduced
    chunk (``own``), its re-quantized chunk (``q2``, ``s2``), the sum every
    rank gets (``sum``) and each rank's noise account (``noise``, (D,)).
    Plain tensor ops; phase 1 sums in rank order."""
    d, length = x.shape
    pad = (-length) % (d * qc.block * 2)
    chunks = torch.nn.functional.pad(x.to(torch.float32),
                                     (0, pad)).reshape(d, d, -1)
    packed = qc.bits == 4
    q1, s1 = zip(*(qops.quantize_plain(chunks[r], qc.qmax, qc.block, packed)
                   for r in range(d)))
    own = [qops.dequantize_sum_plain(torch.stack([q1[r][j] for r in range(d)]),
                                     torch.stack([s1[r][j] for r in range(d)]),
                                     qc.block, packed) for j in range(d)]
    q2, s2 = zip(*(qops.quantize_plain(own[j][None], qc.qmax, qc.block,
                                       packed) for j in range(d)))
    full = torch.cat([qops.dequantize_plain(q2[j], s2[j], qc.block, packed)[0]
                      for j in range(d)])[:length]
    noise = torch.stack([quant_noise_var(s1[r]) * d + quant_noise_var(s2[r])
                         for r in range(d)])
    return {"sum": full, "noise": noise, "q1": q1, "s1": s1, "own": own,
            "q2": q2, "s2": s2}


def emulate_compressed_psum(xs: np.ndarray, qc: QuantConfig) -> dict:
    """``two_phases`` on numpy summands, as numpy (scales as their bf16
    bits, noise accounts as Python floats)."""
    out = two_phases(torch.from_numpy(np.ascontiguousarray(xs, np.float32)),
                     qc)
    bits = lambda v: [s.view(torch.int16).numpy() for s in v]
    return {"sum": out["sum"].numpy(),
            "noise": [float(v) for v in out["noise"]],
            "q1": [q.numpy() for q in out["q1"]], "s1": bits(out["s1"]),
            "own": [o.numpy() for o in out["own"]],
            "q2": [q.numpy() for q in out["q2"]], "s2": bits(out["s2"])}


class EmulatedCompressedPsum:
    """``CompressedPsumTransport`` through the emulated entry points, in
    one process: the P messages summed over D groups of P / D (one a
    rank), ``two_phases`` over the groups, the noise accounts averaged."""

    def __init__(self, d: int, bits: int, block: int):
        self.d, self.qc = d, QuantConfig(bits, block)

    def fuse(self, f_p, delta, symbols=True, drop=None):
        p, n = f_p.shape
        xs = torch.stack([torch.sum(f_p[r * (p // self.d):
                                        (r + 1) * (p // self.d)], dim=-2)
                          for r in range(self.d)])
        out = two_phases(xs, self.qc)
        return out["sum"], torch.mean(out["noise"]), None


# -- the solve service on a mesh (test_torch_mesh_service.py) -----------------

def _results(res) -> list:
    return [{"x": r.x, "sigma2_hat": r.sigma2_hat, "placement":
             r.bucket.placement, "total_bits": r.total_bits,
             "extra_var": r.extra_var} for r in res]


def mesh_service_cases(mesh, data: dict):
    """Rank 0 serves the test's requests through ``SolveService(mesh=)``;
    every other rank runs ``serve_mesh_worker`` until rank 0 closes."""
    from repro_torch.serving import BucketPolicy, PrewarmSpec, SolveRequest
    from repro_torch.serving.service import SolveService, serve_mesh_worker
    if mesh.rank != 0:
        return serve_mesh_worker(mesh)
    req = lambda d: SolveRequest(y=d["y"], a=d["a"],
                                 prior=BernoulliGauss(eps=d["eps"]),
                                 snr_db=d.get("snr_db", 20.0),
                                 n_proc=d["p"], n_iter=d["t"],
                                 policy=d.get("policy", "lossless"),
                                 **{k: d[k] for k in ("erasure_rate",
                                                      "measure_wire")
                                    if k in d})
    out = {}
    svc = SolveService(policy=BucketPolicy(max_batch=8), mesh=mesh,
                       device="cpu")
    out["data"] = _results(svc.solve([req(d) for d in data["data"]]))
    out["data_again"] = _results(svc.solve([req(d) for d in data["data"]]))
    out["data_cache"] = svc.stats()["operand_cache"]
    proc = SolveService(policy=BucketPolicy(shard_elems=1, max_batch=8),
                        mesh=mesh, device="cpu")
    menu = [PrewarmSpec(n=d["a"].shape[1], m=d["a"].shape[0], n_proc=d["p"],
                        n_iter=d["t"], policy=d["policy"],
                        prior=BernoulliGauss(eps=d["eps"]))
            for d in data["proc"]]
    out["prewarm"] = proc.prewarm(menu)
    c0 = proc.compile_count()
    out["proc"] = _results(proc.solve([req(d) for d in data["proc"]]))
    out["programs_after_prewarm"] = proc.compile_count() - c0
    out["proc_erasure"] = _results(proc.solve(
        [req({**data["proc"][0], "erasure_rate": 0.2})]))
    try:
        proc.solve([req({**data["proc"][0], "measure_wire": True})])
        out["wire_refused"] = False
    except ValueError:
        out["wire_refused"] = True
    # a command a worker cannot take: the failure comes back to rank 0 as
    # an exception, every rank ends the command, and serving goes on
    try:
        proc._command({"op": "het", "key": None, "zeros": True,
                       "collect_xs": False}, None, lambda: None)
        out["failure_raised"] = None
    except RuntimeError as e:
        out["failure_raised"] = str(e)
    # operands that would fail only inside the solve's collectives: a
    # worker's malformed schedule, a shard rank 0 cannot build. Both are
    # found before any rank starts the solve, so the command ends at once
    # (not in the group's timeout)
    r0 = req(data["proc"][0])
    key = proc._key_for(r0)
    eng = proc._engine(key)
    header, a_for, own, check = proc._proc_command(key, eng, r0, False)
    bad = {**header, "params": {**header["params"],
                                "sched": header["params"]["sched"][:-1]}}

    def a_fails(rank, ck):
        raise MemoryError("no room for the shard")

    fresh = req({**data["proc"][0], "a": 2.0 * data["proc"][0]["a"]})
    fresh_cmd = proc._proc_command(key, eng, fresh, False)
    for name, args in (("bad_operand", (bad, a_for, own, check)),
                       ("shard_fails", (fresh_cmd[0], a_fails,
                                        *fresh_cmd[2:]))):
        t0 = time.perf_counter()
        try:
            proc._command(*args)
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
        out[name + "_s"] = time.perf_counter() - t0
    out["after_failure"] = _results(proc.solve([req(data["proc"][0])]))
    out["stats"] = mesh.stats.snapshot()
    proc.close()            # stops the mesh's workers, which both served
    return out
