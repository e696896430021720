"""Host-side theory of the PyTorch port against the JAX package.

Denoisers, state evolution, the ECSQ rate model, the RD tables and the DP/BT
allocators are float64 numpy on both sides, so they must agree to rounding:
1e-12 relative (exact where integer). The torch-tensor denoiser is float32
and is held at float32 rounding (1e-5) against the JAX one, and its closed
form derivative against both ``jax.grad`` and ``torch.autograd``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.core.quantize as jq
import repro.core.rate_alloc as jra
import repro.core.rate_distortion as jrd
import repro.core.state_evolution as jse
import repro_torch.core.denoisers as td
import repro_torch.core.quantize as tq
import repro_torch.core.rate_alloc as tra
import repro_torch.core.rate_distortion as trd
import repro_torch.core.state_evolution as tse

RTOL64 = 1e-12     # float64 numpy on both sides
PRIORS = [(0.05, 0.0, 1.0), (0.1, 0.3, 0.7), (0.03, -0.5, 2.0)]


def _priors(p):
    return jd.BernoulliGauss(*p), td.BernoulliGauss(*p)


def _probs(p, n=1000, m=300, snr=20.0):
    jp, tp = _priors(p)
    return (jse.CSProblem(n=n, m=m, prior=jp, snr_db=snr),
            tse.CSProblem(n=n, m=m, prior=tp, snr_db=snr))


@pytest.fixture(scope="module")
def f_grid():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(size=400) * 2.0,
                           np.linspace(-6, 6, 112)]).astype(np.float32)


@pytest.mark.parametrize("p", PRIORS)
@pytest.mark.parametrize("sigma2", [1e-3, 0.05, 0.7])
def test_eta_matches_jax(p, sigma2, f_grid):
    """float32 tensor denoiser == float32 JAX denoiser; 1e-5 for the
    different exp/log implementations of the two libraries."""
    jp, tp = _priors(p)
    want = np.asarray(jd.eta(jnp.asarray(f_grid), sigma2, jp))
    got = td.eta(torch.from_numpy(f_grid), sigma2, tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # numpy path (float64): same formula, same library
    f64 = f_grid.astype(np.float64)
    np.testing.assert_allclose(td.eta(f64, sigma2, tp, xp=np),
                               jd.eta(f64, sigma2, jp, xp=np), rtol=RTOL64)


@pytest.mark.parametrize("p", PRIORS)
@pytest.mark.parametrize("sigma2", [1e-2, 0.3])
def test_eta_bg_and_deriv_matches_jax_and_autograd(p, sigma2, f_grid):
    """Closed-form (eta, eta') of the port vs the JAX closed form, vs
    ``jax.grad`` of the JAX denoiser (what the JAX engine uses) and vs
    ``torch.autograd`` of the port's own eta_bg. float32: 2e-4 absolute on
    a derivative of order 1 covers the cancellation in pi*(1-pi)."""
    eps, mu, sg = p
    jp, tp = _priors(p)
    fj, ft = jnp.asarray(f_grid), torch.from_numpy(f_grid)
    val_j, der_j = jd.eta_bg_and_deriv(fj, sigma2, eps, mu, sg**2)
    val_t, der_t = td.eta_bg_and_deriv(ft, torch.tensor(sigma2), eps, mu,
                                       sg**2)
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(der_t.numpy(), np.asarray(der_j), rtol=1e-4,
                               atol=2e-5)
    # eta_bg alone agrees with eta
    np.testing.assert_allclose(
        td.eta_bg(ft, torch.tensor(sigma2), eps, mu, sg**2).numpy(),
        np.asarray(val_j), rtol=1e-5, atol=1e-6)
    # the JAX engine's derivative: jax.grad through eta
    _, grad_j = jd.eta_and_deriv(fj, sigma2, jp)
    val_e, der_e = td.eta_and_deriv(ft, sigma2, tp)
    np.testing.assert_allclose(val_e.numpy(), val_t.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(der_e.numpy(), np.asarray(grad_j), rtol=1e-4,
                               atol=2e-4)
    # torch.autograd, in float64 where the comparison is sharp
    f64 = torch.from_numpy(f_grid.astype(np.float64)).requires_grad_(True)
    s64 = torch.tensor(sigma2, dtype=torch.float64)
    v64, d64 = td.eta_bg_and_deriv(f64, s64, eps, mu, sg**2)
    (auto,) = torch.autograd.grad(td.eta_bg(f64, s64, eps, mu, sg**2).sum(),
                                  f64)
    np.testing.assert_allclose(d64.detach().numpy(), auto.numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("p", PRIORS)
def test_mmse_and_interp(p):
    jp, tp = _priors(p)
    v = np.geomspace(1e-5, 10.0, 7)
    np.testing.assert_allclose(td.mmse(v, tp, n_nodes=801),
                               jd.mmse(v, jp, n_nodes=801), rtol=RTOL64)
    ji = jd.make_mmse_interp(jp, n_grid=12)
    ti = td.make_mmse_interp(tp, n_grid=12)
    q = np.geomspace(1e-10, 1e4, 33)
    np.testing.assert_allclose(ti(q), ji(q), rtol=RTOL64)
    assert tp.second_moment == jp.second_moment
    assert tp.scaled(-2.0) == td.BernoulliGauss(*dataclass_fields(jp.scaled(-2.0)))


def dataclass_fields(obj):
    return (obj.eps, obj.mu_s, obj.sigma_s)


@pytest.fixture(scope="module")
def mm():
    """One coarse mmse interpolant per prior, shared by both sides' callers
    (the SE/DP/BT functions take it as an argument)."""
    out = {}
    for p in PRIORS:
        out[p] = td.make_mmse_interp(td.BernoulliGauss(*p), n_grid=60)
    return out


@pytest.mark.parametrize("p", PRIORS)
def test_se_trajectories(p, mm):
    jprob, tprob = _probs(p)
    for attr in ("kappa", "rho", "sigma_e2", "sigma0_2"):
        assert getattr(tprob, attr) == getattr(jprob, attr)
    fn = mm[p]
    np.testing.assert_allclose(tse.se_trajectory(tprob, 8, fn),
                               jse.se_trajectory(jprob, 8, fn), rtol=RTOL64)
    sq2 = np.geomspace(1e-4, 1e-6, 8)
    np.testing.assert_allclose(
        tse.se_trajectory_quantized(tprob, sq2, 6, fn),
        jse.se_trajectory_quantized(jprob, sq2, 6, fn), rtol=RTOL64)
    np.testing.assert_allclose(
        tse.se_trajectory_erasure(tprob, sq2, 6, 0.1, fn),
        jse.se_trajectory_erasure(jprob, sq2, 6, 0.1, fn), rtol=RTOL64)
    for kw in ({}, {"n_inner": 2, "erasure_rate": 0.05}):
        got = tse.se_trajectory_col(tprob, 4, 5, mmse_fn=fn, **kw)
        want = jse.se_trajectory_col(jprob, 4, 5, mmse_fn=fn, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL64)
    assert tse.erasure_amplification(0.2, 6) == jse.erasure_amplification(0.2, 6)
    assert tse.steady_state_iters(tprob, mmse_fn=fn) == \
        jse.steady_state_iters(jprob, mmse_fn=fn)
    np.testing.assert_allclose(tse.sdr(sq2 + tprob.sigma_e2, tprob),
                               jse.sdr(sq2 + jprob.sigma_e2, jprob),
                               rtol=RTOL64)
    assert tse.PAPER_T == jse.PAPER_T


@pytest.mark.parametrize("p", PRIORS)
@pytest.mark.parametrize("n_proc", [1, 4, 30])
def test_quantize_rate_model(p, n_proc):
    jp, tp = _priors(p)
    jm = jq.message_mixture(jp, 0.02, n_proc)
    tm = tq.message_mixture(tp, 0.02, n_proc)
    assert (tm.w, tm.mu, tm.var) == (jm.w, jm.mu, jm.var)
    assert (tm.mean, tm.variance) == (jm.mean, jm.variance)
    d = np.geomspace(1e-3, 1.0, 9) * np.sqrt(jm.variance)
    np.testing.assert_allclose(tq.ecsq_entropy(d, tm), jq.ecsq_entropy(d, jm),
                               rtol=RTOL64)
    assert tq.delta_for_sigma_q2(3e-4) == jq.delta_for_sigma_q2(3e-4)
    np.testing.assert_allclose(tq.delta_for_rate_ecsq(3.0, tm),
                               jq.delta_for_rate_ecsq(3.0, jm), rtol=RTOL64)
    jr = jq.residual_mixture(jp, 0.01, 0.3, n_proc)
    tr = tq.residual_mixture(tp, 0.01, 0.3, n_proc)
    assert (tr.w, tr.mu, tr.var) == (jr.w, jr.mu, jr.var)
    assert tq.HIGH_RATE_ECSQ_GAP_BITS == jq.HIGH_RATE_ECSQ_GAP_BITS


def test_quantize_midtread_half_to_even():
    """Symbols are integers: exact, ties included (round half to even)."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49999, 3.2, -7.7],
                 np.float32) * 0.25
    want = np.asarray(jq.quantize_midtread(jnp.asarray(x), 0.25))
    got = tq.quantize_midtread(torch.from_numpy(x), 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tq.dequantize_midtread(torch.from_numpy(got), 0.25).numpy(),
        np.asarray(jq.dequantize_midtread(jnp.asarray(want), 0.25)))


@pytest.mark.parametrize("eps", [0.03, 0.05, 0.10])
def test_rdmodel_reads_committed_cache(eps, monkeypatch):
    """The port's RDModel finds the committed tables (same cache key, byte
    for byte) — a miss would start a ten-minute build, so ``_build`` is
    made to fail instead — and answers every query like the reference."""
    monkeypatch.setattr(trd.RDModel, "_build",
                        lambda self: pytest.fail("RD cache miss in the port"))
    monkeypatch.setattr(jrd.RDModel, "_build",
                        lambda self: pytest.fail("RD cache miss in the reference"))
    jr = jrd.RDModel(jd.BernoulliGauss(eps=eps))
    tr = trd.RDModel(td.BernoulliGauss(eps=eps))
    np.testing.assert_array_equal(tr.log_d, jr.log_d)
    rates = np.linspace(0.0, 9.0, 23)
    sig = np.geomspace(4e-3, 9.0, 23)
    np.testing.assert_allclose(tr.distortion_g(rates[:, None], sig[None, :]),
                               jr.distortion_g(rates[:, None], sig[None, :]),
                               rtol=RTOL64)
    np.testing.assert_allclose(tr.distortion_msg(rates, 0.01, 30),
                               jr.distortion_msg(rates, 0.01, 30), rtol=RTOL64)
    for sq2 in (1e-7, 1e-5, 1e-3):
        assert tr.rate_for_msg_distortion(sq2, 0.01, 30) == \
            jr.rate_for_msg_distortion(sq2, 0.01, 30)


def test_rd_helpers_small():
    jp, tp = _priors((0.1, 0.0, 1.0))
    assert trd.gauss_mixture_entropy(tp, 0.5, n_grid=2001) == \
        jrd.gauss_mixture_entropy(jp, 0.5, n_grid=2001)
    got = trd.ba_rd_curve(tp, 0.5, n_grid=65, n_beta=6, max_iter=50)
    want = jrd.ba_rd_curve(jp, 0.5, n_grid=65, n_beta=6, max_iter=50)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL64)


@pytest.mark.parametrize("kw", [{}, {"erasure_rate": 0.1, "recovery": "rate_up"},
                                {"erasure_rate": 0.1, "recovery": "retransmit"}])
def test_dp_allocate(kw, mm):
    p = (0.05, 0.0, 1.0)
    jprob, tprob = _probs(p)
    jr, tr = jrd.RDModel(jprob.prior), trd.RDModel(tprob.prior)
    want = jra.dp_allocate(jprob, 6, 5, 8.0, dr=0.2, rd=jr, mmse_fn=mm[p], **kw)
    got = tra.dp_allocate(tprob, 6, 5, 8.0, dr=0.2, rd=tr, mmse_fn=mm[p], **kw)
    np.testing.assert_array_equal(got.rates, want.rates)   # grid indices
    np.testing.assert_allclose(got.sigma2_d, want.sigma2_d, rtol=RTOL64)
    np.testing.assert_allclose(got.sigma2_table, want.sigma2_table,
                               rtol=RTOL64)
    if kw:
        np.testing.assert_allclose(got.wire_rates, want.wire_rates,
                                   rtol=RTOL64)
    else:
        assert got.wire_rates is None and want.wire_rates is None
    assert tra.erasure_rate_factors(0.1, "rate_up") == \
        jra.erasure_rate_factors(0.1, "rate_up")


def test_dp_allocate_col(mm):
    p = (0.05, 0.0, 1.0)
    jprob, tprob = _probs(p)
    want = jra.dp_allocate_col(jprob, 4, 4, 6.0, n_inner=2, dr=0.2,
                               mmse_fn=mm[p])
    got = tra.dp_allocate_col(tprob, 4, 4, 6.0, n_inner=2, dr=0.2,
                              mmse_fn=mm[p])
    np.testing.assert_array_equal(got.rates, want.rates)
    np.testing.assert_allclose(got.sigma2_d, want.sigma2_d, rtol=RTOL64)


@pytest.mark.parametrize("rate_model", ["ecsq", "rd"])
def test_bt_controller_and_offline(rate_model, mm):
    p = (0.05, 0.0, 1.0)
    jprob, tprob = _probs(p)
    jr, tr = jrd.RDModel(jprob.prior), trd.RDModel(tprob.prior)
    jc = jra.BTController(jprob, 6, 5, rate_model=rate_model, rd=jr,
                          mmse_fn=mm[p])
    tc = tra.BTController(tprob, 6, 5, rate_model=rate_model, rd=tr,
                          mmse_fn=mm[p])
    np.testing.assert_allclose(tc.sigma2_c, jc.sigma2_c, rtol=RTOL64)
    s2 = jc.sigma2_c
    for t in range(5):
        dj, dt = jc(t, 1.03 * s2[t]), tc(t, 1.03 * s2[t])
        np.testing.assert_allclose(dt, dj, rtol=RTOL64)
    np.testing.assert_allclose(tc.rates, jc.rates, rtol=RTOL64)
    np.testing.assert_allclose(tc.sigma_q2s, jc.sigma_q2s, rtol=RTOL64)
    want = jra.bt_schedule_offline(jprob, 6, 4, rate_model=rate_model, rd=jr,
                                   mmse_fn=mm[p])
    got = tra.bt_schedule_offline(tprob, 6, 4, rate_model=rate_model, rd=tr,
                                  mmse_fn=mm[p])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL64)


def test_stack_schedules():
    sch = [[0.1, 0.2], [0.3, np.inf, 0.5]]
    np.testing.assert_array_equal(tra.stack_schedules(sch, 4),
                                  jra.stack_schedules(sch, 4))
