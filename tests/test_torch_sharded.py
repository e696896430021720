"""Multi-device solves of the port over ``torch.distributed`` against the JAX
package: ``PsumFusion``, ``CompressedPsumTransport``, ``compressed_psum``,
``AmpEngine.solve_sharded`` / ``solve_sharded_het`` (row and column) and
``DistributedMPAMP``.

The port runs on worlds of D = 2 and 4 gloo ranks, spawned processes on the
CPU joined through a FileStore under ``tmp_path`` (no port), one thread
each, every join under a deadline (``tests/torch_spmd.py``); each world is
started once per module and runs every case. The reference runs here, in
the test process, on its single CPU device: its emulated ``AmpEngine.solve``
/ ``solve_het`` on the same numpy data. Its own tier-1 tests pin its
sharded solve to exactly those (``tests/test_engine_sharded.py``), so no
8-device JAX subprocess is started.

Tolerances are the reference tests' own (``tests/test_engine_sharded.py``,
``tests/test_solver_distributed.py``, ``tests/test_compression.py``):

* ``PsumFusion`` exact, row and column (P = 8 and 24): MSE difference
  <= 1e-12, ``sigma2_hat`` rtol 1e-6. A psum of per-rank partial sums adds
  in another order than the emulated sum over P: float32 rounding, not
  bits.
* ``PsumFusion(local=EcsqTransport)``, fixed schedule: ``sigma2_hat`` rtol
  0.02, ``extra_var`` rtol 1e-6, final MSE within 5 %; half the ranks out at
  iteration 3: ``extra_var[3]`` = D / (D - D/2) x the drop-free, rtol 1e-5.
* ``CompressedPsumTransport`` int8 (block 256): MSE < 1.25 x the exact
  solve's, ``extra_var > 0``. Both widths against the reference's
  transport with its collective emulated on stacked arrays by its own
  ``quantize_blocks`` / ``pack_int4`` (``_RefCompressedPsum``): the same
  trajectory to the ECSQ tolerances above (a message summed in another
  order can land in the neighbouring cell). The reference's int4 wire is
  not near-exact at this size: see ``test_compressed_int4_tracks_reference``.
* processor-sharded het (``solve_sharded_het``): lossless, MSE difference
  <= 1e-12 and ``sigma2_hat`` rtol 1e-5 against the reference's
  ``solve_het``; BT, MSE <= 1.3 x the local solve's.
* ``compressed_psum``: bit for bit with the plain single-process emulation
  of its two phases (``torch_spmd.emulate_compressed_psum``), which holds
  the reference's symbols and scales exactly and its sums to 1e-6; the
  collectives carry uint8 payloads, >= 3.9x (int8) / 7.8x (int4) fewer
  wire bytes than a float32 all-reduce of the same message.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.compression as jc
import repro.core.engine as je
import repro.core.rate_alloc as jra
from repro.core.amp import amp_solve, sample_problem
from repro.core.denoisers import BernoulliGauss as JBG
from repro.core.state_evolution import CSProblem
from test_torch_engine import assert_traces_agree
import repro_torch.core.engine as te
from repro_torch.core.compression import QuantConfig
from repro_torch.core.denoisers import BernoulliGauss as TBG

import torch_spmd

WORLDS = (2, 4)
T = 10
EPS = 0.1
DELTAS = np.full(T, 0.05, np.float32)
DELTAS[0] = np.inf
ROW_PS = (8, 24)
COL_CASES = ((8, 1), (24, 1), (8, 2))
HET_P, HET_T, HET_T_ACTIVE = 8, 8, 7


@dataclasses.dataclass(frozen=True)
class _RefCompressedPsum:
    """The reference's ``CompressedPsumTransport`` through its emulated
    entry point: the P messages summed over D groups of P / D (one a rank),
    then ``compressed_psum``'s two phases on the stacked (D, L) partial
    sums with the reference's own ``quantize_blocks`` / ``pack_int4`` /
    ``dequantize_blocks``, and the ranks' noise accounts averaged."""

    d: int
    bits: int
    block: int

    def fuse(self, f_p, delta):
        qc = jc.QuantConfig(self.bits, self.block)
        p, n = f_p.shape
        xs = f_p.reshape(self.d, p // self.d, n).sum(axis=1)
        full, noise = _ref_two_phases(xs, qc)
        return full, jnp.mean(noise), jnp.zeros(())


def _ref_two_phases(xs, qc):
    """compressed_psum for every rank at once: (D, L) summands -> the sum
    every rank gets (L,) and each rank's noise account (D,)."""
    d, length = xs.shape
    flat, _ = jc._pad_to(xs.astype(jnp.float32), d * qc.block * 2)
    chunks = flat.reshape(d, d, -1)                 # [source, dest, C]
    q, scale = jc.quantize_blocks(chunks, qc)
    sf = scale.astype(jnp.float32)
    noise1 = jnp.mean(sf * sf, axis=(1, 2)) / 12.0 * d
    q = jc._wire_decode(jc._wire_encode(q, qc), qc)
    own = jc.dequantize_blocks(q, scale, qc).sum(axis=0)   # (dest, C)
    q2, scale2 = jc.quantize_blocks(own, qc)
    s2 = scale2.astype(jnp.float32)
    noise2 = jnp.mean(s2 * s2, axis=1) / 12.0
    full = jc.dequantize_blocks(jc._wire_decode(jc._wire_encode(q2, qc), qc),
                                scale2, qc).reshape(-1)[:length]
    return full, noise1 + noise2


def _problem(n, m, seed=1):
    prior = JBG(eps=EPS)
    prob = CSProblem(n=n, m=m, prior=prior)
    return sample_problem(jax.random.PRNGKey(seed), n, m, prior,
                          prob.sigma_e2)


def _ref_solve(p, a, y, transport=None, controller=None, layout=None, t=T):
    cfg = je.EngineConfig(n_proc=p, n_iter=t, collect_symbols=False,
                          **({} if layout is None else {"layout": layout}))
    return je.AmpEngine(JBG(eps=EPS), cfg,
                        transport or je.ExactFusion(), controller).solve(y, a)


# -- the het instance (one padded request, as the service pads it) -----------

def _het_instance(policy, col, seed=5):
    """One padded instance (B = 1): the reference's HetParams as numpy, its
    a_b / y_b, and s0. Row: N=1500, M=400 (the reference's proc test);
    column: N=1600, M=320."""
    n, m = (1600, 320) if col else (1500, 400)
    prior = JBG(eps=0.05)
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=20.0)
    s0, a, y = sample_problem(jax.random.PRNGKey(seed), n, m, prior,
                              prob.sigma_e2)
    if col:
        np_pad, m_pad = 208, 336
        a_b = np.zeros((1, HET_P, m_pad, np_pad), np.float32)
        a_b[0, :, :m, :n // HET_P] = np.moveaxis(
            a.reshape(m, HET_P, n // HET_P), 1, 0)
        y_b = np.zeros((1, m_pad), np.float32)
        y_b[0, :m] = y
    else:
        mp_pad, n_pad = 56, 1536
        a_b = np.zeros((1, HET_P, mp_pad, n_pad), np.float32)
        a_b[0, :, :m // HET_P, :n] = a.reshape(HET_P, m // HET_P, n)
        y_b = np.zeros((1, HET_P, mp_pad), np.float32)
        y_b[0, :, :m // HET_P] = y.reshape(HET_P, m // HET_P)
    if policy == "bt":
        ctrl = (je.ColumnBTRateControl(prob, HET_P, HET_T_ACTIVE, 1.05, 6.0,
                                       n_u_grid=16) if col
                else je.BTRateControl(prob, HET_P, HET_T_ACTIVE, 1.005, 6.0,
                                      "ecsq", n_s2_grid=6, n_u_grid=11))
        tables = je.pad_bt_tables(ctrl.tables, HET_T)
    else:
        tables = (je.ColBTTables.dummy(HET_T, n_u=16) if col
                  else je.BTTables.dummy(HET_T, 6, 11))
    hp = je.HetParams(
        sched=jra.stack_schedules([np.full(HET_T_ACTIVE, np.inf, np.float32)],
                                  HET_T),
        t_active=np.asarray([HET_T_ACTIVE], np.int32),
        m_real=np.asarray([m], np.float32), n_real=np.asarray([n], np.int32),
        eps=np.asarray([0.05], np.float32), mu_s=np.zeros(1, np.float32),
        sigma_s=np.ones(1, np.float32), use_bt=np.asarray([policy == "bt"]),
        bt=je.stack_bt_tables([tables]))
    hp = jax.tree.map(np.asarray, hp)
    return a_b, y_b, hp, s0, (n, m)


def _hp_arrays(hp) -> dict:
    """The reference's HetParams as plain numpy (the ranks import no jax)."""
    return {"sched": hp.sched, "t_active": hp.t_active, "m_real": hp.m_real,
            "n_real": hp.n_real, "eps": hp.eps, "mu_s": hp.mu_s,
            "sigma_s": hp.sigma_s, "use_bt": hp.use_bt,
            "bt": [np.asarray(v) for v in hp.bt], "drop": None}


HET_CASES = {"row_lossless": ("lossless", False), "row_bt": ("bt", False),
             "col_lossless": ("lossless", True)}


@pytest.fixture(scope="module")
def data():
    s0, a, y = _problem(2000, 600)
    s0c, a_c, y_c = _problem(2400, 600, seed=2)
    het = {key: _het_instance(policy, col)
           for key, (policy, col) in HET_CASES.items()}
    return {"s0": s0, "a": a, "y": y, "s0_col": s0c, "a_col": a_c,
            "y_col": y_c, "het": het}


L_ODD, L_WIRE = 2999, 8192       # the reference test's odd length; a
#                                  multiple of D * block * 2 (no padding)
SOLVER_T = 12


def _summands(d):
    rng = np.random.default_rng(d)
    return {length: rng.normal(size=(d, length)).astype(np.float32)
            for length in (L_ODD, L_WIRE)}


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """One world of each size runs every case (``torch_spmd.sharded_cases``),
    both started at once, in the background: futures of every rank's
    results, by rank (the reference's solves run meanwhile)."""
    payload = {"a": data["a"], "y": data["y"], "a_col": data["a_col"],
               "y_col": data["y_col"], "t": T, "solver_t": SOLVER_T,
               "eps": EPS, "row_ps": ROW_PS, "col_cases": COL_CASES,
               "deltas": DELTAS, "het_p": HET_P, "het_t": HET_T,
               "het": {key: (a_b, y_b, _hp_arrays(hp), HET_CASES[key][1])
                       for key, (a_b, y_b, hp, _, _) in data["het"].items()}}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {d: pool.submit(
            torch_spmd.run_world, torch_spmd.sharded_cases, d,
            tmp_path_factory.mktemp(f"w{d}"),
            {**payload, "psum": _summands(d)}) for d in WORLDS}


@pytest.fixture(scope="module")
def world_runs(worlds, ref):
    return {d: f.result() for d, f in worlds.items()}


@pytest.fixture(scope="module")
def engine_runs(world_runs):
    """Every sharded engine solve on each world: rank 0's traces, and
    whether every rank returned the same bits."""
    runs = {}
    for d, ranks in world_runs.items():
        ranks = [r["engine"] for r in ranks]
        same = {key: all(np.array_equal(r[key].x, ranks[0][key].x)
                         and np.array_equal(r[key].sigma2_hat,
                                            ranks[0][key].sigma2_hat)
                         for r in ranks[1:])
                for key in ranks[0] if not key.endswith("_stats")}
        runs[d] = (ranks[0], same)
    return runs


@pytest.fixture(scope="module")
def ref(data):
    """The reference's emulated solves on the same data, and the port's
    own emulated solves of the quantized cases (one process, the CPU)."""
    a, y, ac, yc = data["a"], data["y"], data["a_col"], data["y_col"]
    out = {f"row_exact_P{p}": _ref_solve(p, a, y) for p in ROW_PS}
    for p, n_inner in COL_CASES:
        out[f"col_exact_P{p}_i{n_inner}"] = _ref_solve(
            p, ac, yc, layout=je.ColumnPartition(n_inner))
    cfg = je.EngineConfig(n_proc=24, n_iter=T)     # with symbols
    out["ecsq"] = je.AmpEngine(JBG(eps=EPS), cfg, je.EcsqTransport(),
                               je.FixedSchedule(DELTAS)).solve(y, a)
    port = lambda transport, controller=None, symbols=False: te.AmpEngine(
        TBG(eps=EPS), te.EngineConfig(n_proc=24, n_iter=T, device="cpu",
                                      collect_symbols=symbols),
        transport, controller).solve(y, a)
    out["port_ecsq"] = port(te.EcsqTransport(), te.FixedSchedule(DELTAS),
                            symbols=True)
    for d in WORLDS:
        for bits in (8, 4):
            out[f"compressed{bits}_D{d}"] = _ref_solve(
                24, a, y, _RefCompressedPsum(d, bits, 256))
            out[f"port_compressed{bits}_D{d}"] = port(
                torch_spmd.EmulatedCompressedPsum(d, bits, 256))
    return out


def _mse(x, s0):
    return float(np.mean((np.asarray(x) - s0) ** 2))


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("p", ROW_PS)
def test_psum_fusion_row_matches_emulated_exact(engine_runs, ref, d, p):
    got, same = engine_runs[d]
    key = f"row_exact_P{p}"
    assert same[key]
    want = ref[key]
    assert float(np.mean((got[key].x - want.x) ** 2)) <= 1e-12
    np.testing.assert_allclose(got[key].sigma2_hat, want.sigma2_hat,
                               rtol=1e-6)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("p,n_inner", COL_CASES)
def test_psum_fusion_col_matches_emulated_exact(engine_runs, ref, d, p,
                                                n_inner):
    got, same = engine_runs[d]
    key = f"col_exact_P{p}_i{n_inner}"
    assert same[key]
    want = ref[key]
    assert float(np.mean((got[key].x - want.x) ** 2)) <= 1e-12
    np.testing.assert_allclose(got[key].sigma2_hat, want.sigma2_hat,
                               rtol=1e-6)


@pytest.mark.parametrize("d", WORLDS)
def test_psum_fusion_ecsq_local_tracks_emulated(engine_runs, ref, data, d):
    """The reference test's envelope, sharded against emulated in one
    framework: the port's sharded solve against the port's emulated one.
    The two emulated solves, port and reference, part at the first
    quantizer cell a float32 rounding flips (``assert_traces_agree``): the
    reference's own sharded solve parts from its emulated one there too,
    which is its red ``test_solve_sharded_quantized_envelope``
    (ROADMAP.md Queue 3)."""
    got, same = engine_runs[d]
    sh, em = got["ecsq"], ref["port_ecsq"]
    assert same["ecsq"]
    np.testing.assert_allclose(sh.sigma2_hat, em.sigma2_hat, rtol=0.02)
    np.testing.assert_allclose(sh.extra_var, em.extra_var, rtol=1e-6)
    mse_em, mse_sh = _mse(em.x, data["s0"]), _mse(sh.x, data["s0"])
    assert abs(mse_sh - mse_em) <= 0.05 * mse_em + 1e-8, (mse_sh, mse_em)
    assert_traces_agree(ref["ecsq"], em, data["s0"], check_deltas=False)


def test_red_reference_envelope_is_a_cell_flip(engine_runs, ref):
    """Where the reference's sharded run (8 devices) ends, printed by its
    red test: sigma2_hat 0.087110, 0.074785 at iterations 8 and 9, against
    its emulated 0.090170, 0.078416 (4.6 % apart, over its rtol 0.02). The
    port's sharded solves on 2 and 4 ranks and its emulated solve end
    there too: the reference's sharded solve is right, its emulated solve
    took the other side of a quantizer cell."""
    want = np.asarray([0.087110, 0.074785])
    np.testing.assert_allclose(np.asarray(ref["ecsq"].sigma2_hat)[8:],
                               [0.090170, 0.078416], rtol=1e-5)
    np.testing.assert_allclose(ref["port_ecsq"].sigma2_hat[8:], want,
                               rtol=1e-4)
    for d in WORLDS:
        np.testing.assert_allclose(engine_runs[d][0]["ecsq"].sigma2_hat[8:],
                                   want, rtol=1e-4)


@pytest.mark.parametrize("d", WORLDS)
def test_straggler_rescale_amplifies_noise_account(engine_runs, d):
    got, same = engine_runs[d]
    sh, shd = got["ecsq"], got["ecsq_drop"]
    assert same["ecsq_drop"]
    np.testing.assert_allclose(shd.extra_var[3],
                               sh.extra_var[3] * d / (d - d // 2), rtol=1e-5)
    np.testing.assert_allclose(shd.extra_var[4], sh.extra_var[4], rtol=0.5)
    np.testing.assert_array_equal(shd.extra_var[:3], sh.extra_var[:3])


@pytest.mark.parametrize("d", WORLDS)
def test_all_zero_straggler_schedule_gives_drop_free_bits(engine_runs, d):
    """The device transports always take their flag; all zeros multiplies
    by exactly 1.0 (D / D, a division by a tensor)."""
    got, _ = engine_runs[d]
    a, b = got["exact_zero_drop"], got["row_exact_P24"]
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.sigma2_hat, b.sigma2_hat)


@pytest.mark.parametrize("d", WORLDS)
def test_compressed_int8_near_exact_quality(engine_runs, ref, data, d):
    """The reference test's intent: the int8 wire stays near-exact."""
    got, same = engine_runs[d]
    cp = got["compressed8"]
    assert same["compressed8"]
    mse_ex = _mse(ref["row_exact_P24"].x, data["s0"])
    assert _mse(cp.x, data["s0"]) < 1.25 * mse_ex
    assert np.all(cp.extra_var > 0)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_tracks_emulated_transport(engine_runs, ref, data, d,
                                              bits):
    """Both widths, sharded against the same transport emulated in one
    process (``torch_spmd.EmulatedCompressedPsum``): the ECSQ envelope
    above. The emulated transport against the reference's
    (``_RefCompressedPsum``, its own quantizer and packing): the
    statistical part of ``assert_traces_agree`` (the trajectories part at
    a cell flip; no symbols to find it by)."""
    got = engine_runs[d][0][f"compressed{bits}"]
    em = ref[f"port_compressed{bits}_D{d}"]
    np.testing.assert_allclose(got.sigma2_hat, em.sigma2_hat, rtol=0.02)
    np.testing.assert_allclose(got.extra_var, em.extra_var, rtol=0.02)
    mse_e, mse_g = _mse(em.x, data["s0"]), _mse(got.x, data["s0"])
    assert abs(mse_g - mse_e) <= 0.05 * mse_e, (mse_g, mse_e)
    assert np.all(got.extra_var > 0)
    want = ref[f"compressed{bits}_D{d}"]
    np.testing.assert_allclose(em.sigma2_hat, want.sigma2_hat, rtol=0.10)
    np.testing.assert_allclose(em.extra_var, want.extra_var, rtol=0.10)
    assert abs(10 * np.log10(mse_e / _mse(want.x, data["s0"]))) < 1.0


@pytest.mark.parametrize("d", WORLDS)
def test_compressed_int4_tracks_reference(engine_runs, ref, data, d):
    """int4 at block 256 injects ~0.02 of noise variance a phase at this
    size (Delta = amax / 7), and the reference's own int4 solve ends at
    3.0x / 3.1x the exact MSE (D = 2 / 4): the port is held to the
    reference's result (as
    above) and to finite, accounted noise, above int8's, not to the 1.25x
    bound of int8, which the reference itself misses at int4."""
    got = engine_runs[d][0]["compressed4"]
    want = ref[f"compressed4_D{d}"]
    mse_ex = _mse(ref["row_exact_P24"].x, data["s0"])
    assert _mse(want.x, data["s0"]) > 1.25 * mse_ex
    assert np.all(np.isfinite(got.x)) and np.all(got.extra_var > 0)
    assert np.all(got.extra_var > engine_runs[d][0]["compressed8"].extra_var)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_solve_moves_uint8_payloads(engine_runs, d, bits):
    """The solve's fusion crosses the mesh as uint8 only: symbols and bf16
    scales as uint8 views; float32 only in the all-reduces of the plug-in,
    the straggler count and the noise account (a scalar each)."""
    st = engine_runs[d][0][f"compressed{bits}_stats"]
    assert set(st["bytes"]["all_to_all"]) == {"uint8"}
    assert set(st["bytes"]["all_gather"]) == {"uint8"}
    assert st["calls"]["all_to_all"] == 2 * T     # symbols and scales
    assert st["calls"]["all_gather"] == 2 * T
    assert st["bytes"]["all_reduce"]["float32"] == 3 * 4 * T
    assert st["staged"] == 0


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", list(HET_CASES))
def test_sharded_het_matches_reference_solve_het(engine_runs, data, d, key):
    got, same = engine_runs[d]
    a_b, y_b, hp, s0, (n, m) = data["het"][key]
    policy, col = HET_CASES[key]
    cfg = je.EngineConfig(
        n_proc=HET_P, n_iter=HET_T, collect_symbols=False,
        **({"layout": je.ColumnPartition(1)} if col else {}))
    want = je.AmpEngine(JBG(), cfg, je.EcsqTransport()).solve_het(
        a_b, y_b, hp)
    tr = got[f"het_{key}"]
    assert same[f"het_{key}"]
    np.testing.assert_array_equal(tr.x, got[f"het_{key}_own_shard"].x)
    if col:
        x_g = tr.x.reshape(HET_P, -1)[:, :n // HET_P].reshape(-1)
        x_w = np.asarray(want.x)[0].reshape(HET_P, -1)[:, :n // HET_P] \
            .reshape(-1)
    else:
        x_g, x_w = tr.x[:n], np.asarray(want.x)[0, :n]
    s2_w = np.asarray(want.sigma2_hat)[0, :HET_T_ACTIVE]
    if policy == "lossless":
        assert float(np.mean((x_g - x_w) ** 2)) <= 1e-12
        np.testing.assert_allclose(tr.sigma2_hat[:HET_T_ACTIVE], s2_w,
                                   rtol=1e-5)
    else:
        assert _mse(x_g, s0) <= 1.3 * _mse(x_w, s0) + 1e-8
        assert np.isfinite(tr.rates[:HET_T_ACTIVE]).all()


# -- compressed_psum, alone ---------------------------------------------------

@pytest.fixture(scope="module")
def psum_runs(world_runs):
    return {d: (_summands(d), {length: [r["psum"][length] for r in ranks]
                               for length in (L_ODD, L_WIRE)})
            for d, ranks in world_runs.items()}


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [256, 512])
def test_compressed_psum_bit_for_bit_with_emulation(psum_runs, d, bits,
                                                    block):
    xs, ranks = psum_runs[d]
    for length, per_rank in ranks.items():
        emu = torch_spmd.emulate_compressed_psum(xs[length],
                                                 QuantConfig(bits, block))
        for r, res in enumerate(per_rank):
            s, noise, _ = res[(bits, block)]
            np.testing.assert_array_equal(s, emu["sum"])
            assert noise == emu["noise"][r]
        # the reference's tolerance (tests/test_compression.py)
        want = xs[length].sum(0)
        rel = np.abs(emu["sum"] - want).max() / np.abs(want).max()
        assert rel < (0.02 if bits == 8 else 0.25), rel


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_emulation_matches_reference_functions(psum_runs, d, bits):
    """The emulation's phases against the reference's ``quantize_blocks`` /
    ``pack_int4`` / ``dequantize_blocks`` run in the same order: symbols
    and scales exact, the sums to 1e-6 relative."""
    xs, _ = psum_runs[d]
    x = xs[L_ODD]
    qc_t, qc_j = QuantConfig(bits, 256), jc.QuantConfig(bits, 256)
    emu = torch_spmd.emulate_compressed_psum(x, qc_t)
    flat, _ = jc._pad_to(jnp.asarray(x), d * 256 * 2)
    chunks = flat.reshape(d, d, -1)
    for r in range(d):
        q, scale = jc.quantize_blocks(chunks[r], qc_j)
        np.testing.assert_array_equal(emu["q1"][r],
                                      np.asarray(jc._wire_encode(q, qc_j)))
        np.testing.assert_array_equal(emu["s1"][r],
                                      np.asarray(scale).view(np.int16))
    for j in range(d):
        q_r, s_r = zip(*(jc.quantize_blocks(chunks[r, j][None], qc_j)
                         for r in range(d)))
        own = jc.dequantize_blocks(jnp.concatenate(q_r),
                                   jnp.concatenate(s_r), qc_j).sum(axis=0)
        np.testing.assert_allclose(emu["own"][j], np.asarray(own), rtol=1e-6,
                                   atol=1e-6 * float(jnp.abs(own).max()))
        q2, s2 = jc.quantize_blocks(jnp.asarray(emu["own"][j])[None], qc_j)
        np.testing.assert_array_equal(emu["q2"][j],
                                      np.asarray(jc._wire_encode(q2, qc_j)))
        np.testing.assert_array_equal(emu["s2"][j],
                                      np.asarray(s2).view(np.int16))


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("bits,ratio", [(8, 3.9), (4, 7.8)])
def test_compressed_psum_wire_bytes(psum_runs, d, bits, ratio):
    """uint8 payloads only, and per rank >= 3.9x / 7.8x fewer bytes on the
    wire than a float32 ring all-reduce of the same message (2 (D-1)/D of
    it, each way; the all-to-all sends (D-1)/D of what it is handed, the
    ring all-gather D-1 times its piece)."""
    _, ranks = psum_runs[d]
    for block in (256, 512):
        st = ranks[L_WIRE][0][(bits, block)][2]
        assert st["calls"] == {"all_to_all": 2, "all_gather": 2}
        assert all(set(v) == {"uint8"} for v in st["bytes"].values())
        handed = {op: sum(v.values()) for op, v in st["bytes"].items()}
        wire = (handed["all_to_all"] * (d - 1) / d
                + handed["all_gather"] * (d - 1))
        f32_ring = 2 * (d - 1) / d * 4 * L_WIRE
        assert f32_ring / wire >= ratio, (f32_ring / wire, block)


# -- DistributedMPAMP ----------------------------------------------------------

@pytest.fixture(scope="module")
def solver_runs(world_runs):
    return {d: [r["solver"] for r in ranks]
            for d, ranks in world_runs.items()}


@pytest.mark.parametrize("d", WORLDS)
def test_distributed_solver_matches_centralized(solver_runs, data, d):
    """The reference's ``test_distributed_solver_matches_centralized``
    with P = D: exact fusion == centralized AMP; int8 near-centralized,
    its noise accounted; 15 % stragglers still converge; the column layout
    (C-MP-AMP, one inner iteration) exact == centralized AMP too."""
    s0, a, y = data["s0"], data["a"], data["y"]
    prior = JBG(eps=EPS)
    ranks = solver_runs[d]
    res = ranks[0]
    for r in ranks[1:]:
        for key in res:
            np.testing.assert_array_equal(r[key][0], res[key][0])
    want = amp_solve(y, a, prior, SOLVER_T, s0=s0)
    x, _, _ = res["exact"]
    assert abs(_mse(x, s0) - want.mse[-1]) < 1e-6
    x8, _, nv = res["int8"]
    assert _mse(x8, s0) < want.mse[-1] * 1.25
    assert np.all(nv > 0)
    _, _, nv4 = res["int4"]
    assert np.all(nv4 > nv)
    xd, _, _ = res["int8_drop"]
    assert _mse(xd, s0) < 0.5 * prior.second_moment
    want_col = amp_solve(data["y_col"], data["a_col"], prior, SOLVER_T,
                         s0=data["s0_col"])
    assert abs(_mse(res["col_exact"][0], data["s0_col"])
               - want_col.mse[-1]) < 1e-6
