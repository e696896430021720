"""The frontends of the PyTorch port (``mp_amp_solve`` with every kind of
schedule, ``MPAMPResult`` rate accounting) against the JAX frontends.

Tolerances follow tests/test_torch_engine.py. ``MPAMPResult`` carries no
symbols, so a quantizer cell that differs between the two float32 runs
cannot be located here: with fine fixed bins the trajectories are held to
1e-3 (one changed cell moves the MSE by far less) and the final x to two
final bin widths (a changed cell in the last fusion moves one entry by one
bin; without one the difference is about 1e-6); with coarse on-line bins
(BT, a Python controller) the runs are held statistically. The rate
accounting is held on the same trace, where it is float64 numpy on both
sides.
"""
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.core.mp_amp as jmp
import repro.core.rate_alloc as jra
import repro.core.state_evolution as jse
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
import repro_torch.core.mp_amp as tmp
import repro_torch.core.rate_alloc as tra
import repro_torch.core.state_evolution as tse

N, M, P, T = 1024, 384, 6, 8
EPS = 0.1
JCFG = jmp.MPAMPConfig(P, T)
TCFG = tmp.MPAMPConfig(P, T, device="cpu")
FIXED = [np.inf, 0.05, 0.03, 0.02, 0.02, 0.01, 0.01, 0.005]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(4)
    jp, tp = jd.BernoulliGauss(EPS), td.BernoulliGauss(EPS)
    jprob, tprob = jse.CSProblem(N, M, jp), tse.CSProblem(N, M, tp)
    s0 = ((rng.random(N) < EPS) * rng.normal(size=N)).astype(np.float32)
    a = (rng.normal(size=(M, N)) / np.sqrt(M)).astype(np.float32)
    y = (a @ s0 + np.sqrt(tprob.sigma_e2) * rng.normal(size=M)).astype(np.float32)
    mm = td.make_mmse_interp(tp, n_grid=100)
    return jp, tp, jprob, tprob, s0, a, y, mm


def _agree(want, got, tight=True):
    """MPAMPResult vs MPAMPResult. ``tight``: fine fixed bins, at most a
    few quantizer cells differ; otherwise the runs agree statistically
    (module docstring)."""
    np.testing.assert_array_equal(np.isfinite(got.deltas),
                                  np.isfinite(want.deltas))
    fin = np.isfinite(want.deltas)
    if tight:
        np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat, rtol=1e-3)
        np.testing.assert_allclose(got.mse, want.mse, rtol=1e-3)
        np.testing.assert_allclose(got.x, want.x,
                                   atol=1e-4 + 2 * want.deltas[fin][-1])
        assert np.mean(np.abs(got.x - want.x) > 1e-4) <= 2e-3
        np.testing.assert_allclose(got.deltas[fin], want.deltas[fin], rtol=1e-4)
        np.testing.assert_allclose(got.rates_analytic[fin],
                                   want.rates_analytic[fin], rtol=1e-3)
        np.testing.assert_allclose(got.rates_empirical[fin],
                                   want.rates_empirical[fin], rtol=1e-3)
    else:
        np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat, rtol=0.10)
        assert abs(10 * np.log10(got.mse[-1] / want.mse[-1])) < 1.0
        np.testing.assert_allclose(got.deltas[fin], want.deltas[fin], rtol=0.10)
        np.testing.assert_allclose(got.total_bits_analytic,
                                   want.total_bits_analytic, rtol=0.05)
        np.testing.assert_allclose(got.total_bits_empirical,
                                   want.total_bits_empirical, rtol=0.05)


def test_mp_amp_solve_with_list(setup):
    jp, tp, _, _, s0, a, y, _ = setup
    want = jmp.mp_amp_solve(y, a, jp, JCFG, FIXED, s0=s0)
    got = tmp.mp_amp_solve(y, a, tp, TCFG, FIXED, s0=s0)
    _agree(want, got)
    assert np.isinf(got.rates_analytic[0]) and np.isinf(got.rates_empirical[0])
    assert got.total_bits_analytic < 32 * T
    # a longer list is valid: the first n_iter entries are used
    again = tmp.mp_amp_solve(y, a, tp, TCFG, FIXED + [1.0, 1.0], s0=s0)
    np.testing.assert_array_equal(again.x, got.x)
    # tensors are taken as well as numpy arrays
    tens = tmp.mp_amp_solve(torch.from_numpy(y), torch.from_numpy(a), tp,
                            TCFG, FIXED, s0=s0)
    np.testing.assert_array_equal(tens.x, got.x)


def test_mp_amp_solve_with_sigma2_for_model(setup):
    jp, tp, _, tprob, s0, a, y, mm = setup
    model = tse.se_trajectory(tprob, T, mm)[:-1]
    want = jmp.mp_amp_solve(y, a, jp, JCFG, FIXED, s0=s0,
                            sigma2_for_model=model)
    got = tmp.mp_amp_solve(y, a, tp, TCFG, FIXED, s0=s0,
                           sigma2_for_model=model)
    fin = np.isfinite(got.deltas)
    # same bins, same model variances: the analytic rate is float64 numpy
    np.testing.assert_allclose(got.rates_analytic[fin],
                               want.rates_analytic[fin], rtol=1e-12)


def test_mp_amp_solve_with_bt_controller(setup):
    """A host ``BTController`` is handed over to the on-device
    ``BTRateControl``; its record-keeping contract is preserved."""
    jp, tp, jprob, tprob, s0, a, y, mm = setup
    jbt = jra.BTController(jprob, P, T, c_ratio=1.02, mmse_fn=mm)
    tbt = tra.BTController(tprob, P, T, c_ratio=1.02, mmse_fn=mm)
    want = jmp.mp_amp_solve(y, a, jp, JCFG, jbt, s0=s0)
    got = tmp.mp_amp_solve(y, a, tp, TCFG, tbt, s0=s0)
    _agree(want, got, tight=False)
    assert isinstance(tbt._in_graph, te.BTRateControl)
    assert len(tbt.rates) == len(tbt.sigma_q2s) == T
    np.testing.assert_allclose(tbt.sigma_q2s, got.deltas.astype(np.float64) ** 2 / 12.0,
                               rtol=1e-6)
    assert max(tbt.rates) <= 6.0 + 1e-4
    # second solve with the same controller reuses tables and engine
    tables, engine = tbt._in_graph, tbt._in_graph._engine
    tmp.mp_amp_solve(y, a, tp, TCFG, tbt, s0=s0)
    assert tbt._in_graph is tables and tables._engine is engine
    assert engine.dispatch_count == 2 and len(tbt.rates) == 2 * T


def test_mp_amp_solve_with_engine_controller(setup):
    jp, tp, _, _, s0, a, y, _ = setup
    import repro.core.engine as je
    want = jmp.mp_amp_solve(y, a, jp, JCFG, je.FixedSchedule(FIXED), s0=s0)
    got = tmp.mp_amp_solve(y, a, tp, TCFG, te.FixedSchedule(FIXED), s0=s0)
    _agree(want, got)


def test_mp_amp_solve_with_python_callable(setup):
    """An arbitrary callable goes through the per-iteration host loop."""
    jp, tp, _, _, s0, a, y, _ = setup
    seen = []

    def ctrl(t, s2):
        seen.append((t, s2))
        return 2.0 * np.sqrt(s2 / P) / 8.0

    want = jmp.mp_amp_solve(y, a, jp, JCFG, lambda t, s2: 2.0 * np.sqrt(s2 / P) / 8.0, s0=s0)
    got = tmp.mp_amp_solve(y, a, tp, TCFG, ctrl, s0=s0)
    assert [t for t, _ in seen] == list(range(T))
    assert all(isinstance(s2, float) for _, s2 in seen)
    _agree(want, got, tight=False)
    np.testing.assert_allclose(got.deltas, [2.0 * np.sqrt(s / P) / 8.0
                                            for s in got.sigma2_hat], rtol=1e-6)


def test_rate_accounting_on_the_same_trace(setup):
    """``_result_from_trace`` of both frontends on one and the same trace:
    the accounting itself is float64 numpy, so 1e-12."""
    jp, tp, _, _, s0, a, y, _ = setup
    eng = te.AmpEngine(tp, te.EngineConfig(n_proc=P, n_iter=T, device="cpu"),
                       te.EcsqTransport(), te.FixedSchedule(FIXED))
    trace = eng.solve(y, a)
    got = tmp._result_from_trace(trace, tp, TCFG, s0, None)
    want = jmp._result_from_trace(trace, jp, JCFG, s0, None)
    for name in ("rates_analytic", "rates_empirical", "mse", "deltas",
                 "sigma2_hat"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, err_msg=name)
    assert got.total_bits_analytic == want.total_bits_analytic
    assert got.total_bits_empirical == want.total_bits_empirical
    q = trace.symbols[3]
    assert tmp._empirical_entropy(q) == jmp._empirical_entropy(q)


def test_single_step_pieces_match_jax(setup):
    import jax.numpy as jnp
    jp, tp, _, _, s0, a, y, _ = setup
    a_p, y_p = tmp.split_problem(a, y, P)
    rng = np.random.default_rng(9)
    x = (s0 + 0.05 * rng.normal(size=N)).astype(np.float32)
    z_p = rng.normal(size=y_p.shape).astype(np.float32) * 0.1
    zj, fj, sj = jmp.mp_local_step(jnp.asarray(x), jnp.asarray(z_p),
                                   jnp.float32(0.4), jnp.asarray(a_p),
                                   jnp.asarray(y_p))
    zt, ft, st = tmp.mp_local_step(torch.from_numpy(x), torch.from_numpy(z_p),
                                   0.4, torch.from_numpy(a_p.copy()),
                                   torch.from_numpy(y_p.copy()))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    xj, oj, qj = jmp.mp_fusion_step(fj, sj, jnp.float32(0.02), jp, M / N)
    xt, ot, qt = tmp.mp_fusion_step(torch.from_numpy(np.array(fj)),
                                    torch.tensor(float(sj)), 0.02, tp, M / N)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ot), float(oj), rtol=1e-5)


@pytest.mark.tier2
def test_golden_operating_point_port_vs_reference():
    """The paper's operating point of tests/test_golden_operating_point.py
    (kappa=0.3, 20 dB, eps=0.05, P=30, T=10, N=4000; the reference's own
    PRNGKey(42) problem, handed over as numpy): BT- and DP-rated solves of
    the port against the reference as it computes today. Total bits within
    2 % (that test's own drift bound), final SDR within 0.5 dB (two
    realisations of the quantization noise)."""
    import jax
    import repro.core.engine as je
    import repro.core.rate_distortion as jrd
    import repro_torch.core.rate_distortion as trd
    from repro.core.amp import sample_problem
    n, m, p, t = 4000, 1200, 30, 10
    jp, tp = jd.BernoulliGauss(eps=0.05), td.BernoulliGauss(eps=0.05)
    jprob = jse.CSProblem(n=n, m=m, prior=jp, snr_db=20.0)
    tprob = tse.CSProblem(n=n, m=m, prior=tp, snr_db=20.0)
    mm = td.make_mmse_interp(tp)
    s0, a, y = (np.array(v) for v in sample_problem(
        jax.random.PRNGKey(42), n, m, jp, jprob.sigma_e2))
    sdr = lambda mse: 10 * np.log10(tp.second_moment / mse)
    jcfg, tcfg = jmp.MPAMPConfig(p, t), tmp.MPAMPConfig(p, t, device="cpu")

    jbt = jra.BTController(jprob, p, t, c_ratio=1.005, r_max=6.0,
                           rate_model="ecsq", mmse_fn=mm)
    tbt = tra.BTController(tprob, p, t, c_ratio=1.005, r_max=6.0,
                           rate_model="ecsq", mmse_fn=mm)
    want = jmp.mp_amp_solve(y, a, jp, jcfg, jbt, s0=s0)
    got = tmp.mp_amp_solve(y, a, tp, tcfg, tbt, s0=s0)
    print("BT bits", want.total_bits_analytic, got.total_bits_analytic,
          "SDR", sdr(want.mse[-1]), sdr(got.mse[-1]))
    np.testing.assert_allclose(got.total_bits_analytic,
                               want.total_bits_analytic, rtol=0.02)
    assert abs(sdr(got.mse[-1]) - sdr(want.mse[-1])) < 0.5

    jr, tr = jrd.RDModel(jp), trd.RDModel(tp)
    jdp = jra.dp_allocate(jprob, p, t, 2.0 * t, rd=jr, mmse_fn=mm)
    tdp = tra.dp_allocate(tprob, p, t, 2.0 * t, rd=tr, mmse_fn=mm)
    want = jmp.mp_amp_solve(y, a, jp, jcfg, je.DPSchedule(jdp, jr, p).deltas,
                            s0=s0, sigma2_for_model=jdp.sigma2_d[:-1])
    got = tmp.mp_amp_solve(y, a, tp, tcfg, te.DPSchedule(tdp, tr, p).deltas,
                           s0=s0, sigma2_for_model=tdp.sigma2_d[:-1])
    print("DP bits", want.total_bits_analytic, got.total_bits_analytic,
          "SDR", sdr(want.mse[-1]), sdr(got.mse[-1]))
    np.testing.assert_allclose(got.total_bits_analytic,
                               want.total_bits_analytic, rtol=1e-9)
    assert abs(sdr(got.mse[-1]) - sdr(want.mse[-1])) < 0.5
