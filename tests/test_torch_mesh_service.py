"""The port's solve service on a device mesh (``SolveService(mesh=...)``,
the ``"data"`` and ``"proc"`` placements, ``serve_mesh_worker``) and
``launch/amp_serve.py --mesh`` against the JAX package's single-device
service, on the CPU.

The port runs on worlds of D = 2 and 4 gloo ranks (spawned processes, a
FileStore under ``tmp_path``, every join under a deadline;
``tests/torch_spmd.py``): rank 0 owns the service, the others run the
worker loop. The reference runs here, in the test process: its local
``SolveService`` on the same numpy requests, which its own tier-1 tests
pin its mesh placements to (``tests/test_engine_sharded.py``:
``test_service_data_parallel_matches_local``,
``test_solve_sharded_het_matches_solve_het``).

Tolerances are those tests': a data-parallel request <= 1e-10 of the local
result (mean squared difference of x); a processor-sharded lossless one <=
1e-12 with ``sigma2_hat`` rtol 1e-5, a BT one MSE <= 1.3 x the local one's.
"""
import concurrent.futures
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.amp import sample_problem
from repro.core.denoisers import BernoulliGauss as JBG
from repro.core.state_evolution import CSProblem
from repro.serving import BucketPolicy as JPolicy
from repro.serving import SolveRequest as JRequest
from repro.serving.service import SolveService as JService

import torch_spmd

WORLDS = (2, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data_requests():
    """The reference's data-parallel test: 6 requests (padded to 8), mixed
    iteration budgets, N=512, M=128, P=4, lossless."""
    prior = JBG(eps=0.1)
    prob = CSProblem(n=512, m=128, prior=prior)
    out = []
    for i in range(6):
        s0, a, y = sample_problem(jax.random.PRNGKey(i), prob.n, prob.m,
                                  prior, prob.sigma_e2)
        out.append({"a": a, "y": y, "s0": s0, "eps": 0.1, "p": 4,
                    "t": 4 + (i % 3), "policy": "lossless"})
    return out


def _proc_requests():
    """The reference's processor-sharded test: N=1500, M=400, eps 0.05,
    20 dB, P=8, T=7, lossless and BT."""
    prior = JBG(eps=0.05)
    prob = CSProblem(n=1500, m=400, prior=prior, snr_db=20.0)
    s0, a, y = sample_problem(jax.random.PRNGKey(5), prob.n, prob.m, prior,
                              prob.sigma_e2)
    return [{"a": a, "y": y, "s0": s0, "eps": 0.05, "p": 8, "t": 7,
             "policy": policy} for policy in ("lossless", "bt")]


def _jreq(d):
    return JRequest(y=d["y"], a=d["a"], prior=JBG(eps=d["eps"]),
                    snr_db=20.0, n_proc=d["p"], n_iter=d["t"],
                    policy=d["policy"])


@pytest.fixture(scope="module")
def reqs():
    return {"data": _data_requests(), "proc": _proc_requests()}


@pytest.fixture(scope="module")
def ref(reqs):
    """The reference's local service on the same requests."""
    loc = JService(policy=JPolicy(max_batch=8))
    return {"data": loc.solve([_jreq(d) for d in reqs["data"]]),
            "proc": loc.solve([_jreq(d) for d in reqs["proc"]])}


@pytest.fixture(scope="module")
def worlds(reqs, tmp_path_factory):
    """Both worlds started at once, in the background (the reference's
    service runs meanwhile): futures of every rank's results."""
    strip = lambda ds: [{k: v for k, v in d.items() if k != "s0"}
                        for d in ds]
    payload = {"data": strip(reqs["data"]), "proc": strip(reqs["proc"])}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {d: pool.submit(torch_spmd.run_world,
                              torch_spmd.mesh_service_cases, d,
                              tmp_path_factory.mktemp(f"svc{d}"), payload)
               for d in WORLDS}


@pytest.fixture(scope="module")
def runs(worlds, ref):
    return {d: f.result() for d, f in worlds.items()}


@pytest.mark.parametrize("d", WORLDS)
def test_data_parallel_matches_local(runs, ref, d):
    got = runs[d][0]
    assert all(r["placement"] == "data" for r in got["data"])
    for rm, rl in zip(got["data"], ref["data"]):
        assert float(np.mean((rm["x"] - np.asarray(rl.x)) ** 2)) <= 1e-10


@pytest.mark.parametrize("d", WORLDS)
def test_data_parallel_repeat_sends_no_a(runs, d):
    """The second pass finds every rank's A in its operand cache: the same
    bits, and no A crosses the mesh again (rank 0's hits; the workers'
    caches report theirs when they stop)."""
    got = runs[d][0]
    for a, b in zip(got["data"], got["data_again"]):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert got["data_cache"]["hits"] > 0
    for worker in runs[d][1:]:
        assert worker["operand_cache"]["hits"] > 0
        assert worker["commands"] > 0


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("i,policy", [(0, "lossless"), (1, "bt")])
def test_proc_sharded_matches_local(runs, ref, reqs, d, i, policy):
    got = runs[d][0]["proc"][i]
    want = ref["proc"][i]
    s0 = reqs["proc"][i]["s0"]
    assert got["placement"] == "proc"
    dx = float(np.mean((got["x"] - np.asarray(want.x)) ** 2))
    if policy == "lossless":
        assert dx <= 1e-12, dx
        np.testing.assert_allclose(got["sigma2_hat"], want.sigma2_hat,
                                   rtol=1e-5)
    else:
        mse_p = float(np.mean((got["x"] - s0) ** 2))
        mse_l = float(np.mean((np.asarray(want.x) - s0) ** 2))
        assert mse_p <= 1.3 * mse_l + 1e-8, (mse_p, mse_l)
        assert np.isfinite(got["total_bits"])


@pytest.mark.parametrize("d", WORLDS)
def test_prewarm_covers_the_proc_programs(runs, d):
    got = runs[d][0]
    assert got["prewarm"]["programs"] == 2
    assert got["programs_after_prewarm"] == 0


@pytest.mark.parametrize("d", WORLDS)
def test_proc_erasure_masks_ranks(runs, reqs, d):
    """On the proc placement the erasure mask's axis is the mesh's ranks:
    a lossy link costs MSE and inflates the noise account."""
    got = runs[d][0]
    s0 = reqs["proc"][0]["s0"]
    er, clean = got["proc_erasure"][0], got["proc"][0]
    assert er["placement"] == "proc" and np.all(np.isfinite(er["x"]))
    assert np.mean((er["x"] - s0) ** 2) > np.mean((clean["x"] - s0) ** 2)


@pytest.mark.parametrize("d", WORLDS)
def test_measure_wire_refused_on_proc(runs, d):
    assert runs[d][0]["wire_refused"] is True


@pytest.mark.parametrize("d", WORLDS)
def test_worker_failure_ends_the_command(runs, d):
    """A command a worker cannot take raises on rank 0 with the worker's
    traceback; no rank waits on, and the next request is served."""
    got = runs[d][0]
    assert got["failure_raised"] and "rank 1" in got["failure_raised"]
    np.testing.assert_array_equal(got["after_failure"][0]["x"],
                                  got["proc"][0]["x"])


@pytest.mark.parametrize("d", WORLDS)
def test_operand_failure_ends_before_the_solve(runs, d):
    """A worker's malformed operand (a schedule one iteration short) and a
    shard rank 0 cannot build both end the command in the ready round:
    rank 0 raises with the failing ranks' tracebacks within seconds, far
    inside the group's 600 s timeout that a failure inside the solve's
    collectives would wait for, and the next request is served."""
    got = runs[d][0]
    bad = got["bad_operand"]
    assert bad and "params.sched" in bad
    assert all(f"rank {r}:" in bad for r in range(1, d))
    assert "rank 0:" not in bad
    assert got["shard_fails"] and "no room for the shard" in \
        got["shard_fails"]
    assert got["bad_operand_s"] < 30.0 and got["shard_fails_s"] < 30.0
    np.testing.assert_array_equal(got["after_failure"][0]["x"],
                                  got["proc"][0]["x"])


@pytest.mark.parametrize("d", WORLDS)
def test_mesh_payloads(runs, d):
    """A repeat request sends no A (point-to-point sends only for cache
    misses); the solves' collectives are gloo all-reduces on the CPU,
    never staged through the host (nothing to stage)."""
    st = runs[d][0]["stats"]
    assert st["calls"]["all_reduce"] > 0
    assert st["staged"] == 0


def test_amp_serve_mesh_smoke(tmp_path):
    """``amp_serve --mesh 2`` on the CPU: rank 0 spawns a worker, serves
    the smoke stream over both placements, stops the worker, exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.amp_serve", "--smoke",
         "--mesh", "2", "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "a mesh of 2 gloo ranks" in out.stdout
    assert "'data'" in out.stdout and "'proc'" in out.stdout
