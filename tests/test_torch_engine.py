"""The row engine of the PyTorch port against the JAX engine, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The port
runs with ``device="cpu"`` (plain versions of its kernels); the JAX engine
runs its jnp path, as it does on any CPU.

Tolerances. Both sides are float32 with sums taken in different orders, so
a single step agrees to about 1e-6 and a whole lossless solve to 1e-3 on
the ``sigma2_hat`` / MSE trajectories and 1e-4 on the final x. A quantized
solve adds a discontinuity: a 1-ulp difference in a message f_p, or a BT
bin size that differs in its sixth digit, can put an entry in the
neighbouring quantizer cell (symbol off by one). From the first iteration
where that happens the two runs carry different realisations of the
quantization noise and agree only statistically; at coarse bins (BT and DP
spend under 2 bits in some iterations) one changed cell moves an entry of x
by a whole bin. ``assert_traces_agree`` therefore holds the runs to the
tight tolerances up to the first iteration whose symbols differ, demands
that they differ there by at most one cell on at most 1e-3 of the entries,
and afterwards holds ``sigma2_hat`` to 10 % and the final MSE to 1 dB.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.amp as jamp
import repro.core.denoisers as jd
import repro.core.engine as je
import repro.core.rate_alloc as jra
import repro.core.rate_distortion as jrd
import repro.core.state_evolution as jse
import repro_torch.core.amp as tamp
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
import repro_torch.core.mp_amp as tmp
import repro_torch.core.rate_alloc as tra
import repro_torch.core.rate_distortion as trd
import repro_torch.core.state_evolution as tse
from repro_torch import convert

N, M, P, T = 1024, 384, 6, 8
EPS = 0.1


def make_problem(seed, n=N, m=M, eps=EPS):
    rng = np.random.default_rng(seed)
    prob = tse.CSProblem(n=n, m=m, prior=td.BernoulliGauss(eps))
    s0 = ((rng.random(n) < eps) * rng.normal(size=n)).astype(np.float32)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)).astype(np.float32)
    return s0, a, y


@pytest.fixture(scope="module")
def problem():
    return make_problem(1)


@pytest.fixture(scope="module")
def priors():
    return jd.BernoulliGauss(EPS), td.BernoulliGauss(EPS)


@pytest.fixture(scope="module")
def probs(priors):
    return (jse.CSProblem(N, M, priors[0]), tse.CSProblem(N, M, priors[1]))


@pytest.fixture(scope="module")
def mm(priors):
    return td.make_mmse_interp(priors[1], n_grid=100)


@pytest.fixture(scope="module")
def bt_pair(probs, mm):
    """BT controllers built independently on both sides (c_ratio 1.02)."""
    return (je.BTRateControl(probs[0], P, T, c_ratio=1.02, mmse_fn=mm),
            te.BTRateControl(probs[1], P, T, c_ratio=1.02, mmse_fn=mm))


def j_engine(prior, ctrl, transport=None, **kw):
    return je.AmpEngine(prior, je.EngineConfig(n_proc=P, n_iter=T, **kw),
                        transport or je.EcsqTransport(), ctrl)


def t_engine(prior, ctrl, transport=None, **kw):
    return te.AmpEngine(prior, te.EngineConfig(n_proc=P, n_iter=T,
                                               device="cpu", **kw),
                        transport or te.EcsqTransport(), ctrl)


def assert_traces_agree(want, got, s0, check_deltas=True):
    """Module docstring: tight until the first differing symbol, one cell on
    <= 1e-3 of the entries there, statistical afterwards."""
    n_iter = len(np.asarray(want.sigma2_hat))
    sym_w = None if want.symbols is None else np.asarray(want.symbols)
    first = n_iter
    if sym_w is not None:
        differs = [bool((sym_w[t] != got.symbols[t]).any())
                   for t in range(n_iter)]
        if any(differs):
            first = differs.index(True)
            d = np.abs(sym_w[first] - got.symbols[first])
            assert d.max() <= 1.0, f"iteration {first}: symbols off by {d.max()}"
            assert (d > 0).mean() <= 1e-3, \
                f"iteration {first}: {(d > 0).mean():.2e} of symbols differ"
    upto = min(first + 1, n_iter)
    s2_w, s2_g = np.asarray(want.sigma2_hat), np.asarray(got.sigma2_hat)
    np.testing.assert_allclose(s2_g[:upto], s2_w[:upto], rtol=1e-3)
    if check_deltas:
        np.testing.assert_allclose(np.asarray(got.deltas)[:upto],
                                   np.asarray(want.deltas)[:upto], rtol=1e-4)
        np.testing.assert_allclose(np.asarray(got.rates)[:upto],
                                   np.asarray(want.rates)[:upto], rtol=1e-4)
    mse_w, mse_g = want.mse(s0), got.mse(s0)
    np.testing.assert_allclose(mse_g[:first], mse_w[:first], rtol=1e-3)
    if first == n_iter:
        np.testing.assert_allclose(got.x, np.asarray(want.x), atol=1e-4)
    else:
        np.testing.assert_allclose(s2_g, s2_w, rtol=0.10)
        assert abs(10 * np.log10(mse_g[-1] / mse_w[-1])) < 1.0
    return first


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_split_problem_and_gc_step(problem, priors):
    s0, a, y = problem
    ja, jy = je.split_problem(a, y, P)
    ta, ty = te.split_problem(torch.from_numpy(a), torch.from_numpy(y), P)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(ty.numpy(), jy)
    rng = np.random.default_rng(3)
    f = (s0 + 0.1 * rng.normal(size=N)).astype(np.float32)
    xj, oj = je.amp_gc_step(jnp.asarray(f), jnp.float32(0.01), priors[0],
                            M / N)
    xt, ot = te.amp_gc_step(torch.from_numpy(f), torch.tensor(0.01),
                            priors[1], M / N)
    # closed-form derivative here, jax.grad there: float32 rounding
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ot), float(oj), rtol=1e-5)


@pytest.mark.parametrize("delta", [np.inf, 0.05, 0.004])
def test_ecsq_fuse_matches(delta):
    """Same f_p, same delta: symbols exact, f and extra to 1e-6."""
    rng = np.random.default_rng(5)
    f_p = (rng.normal(size=(P, N)) * 0.3).astype(np.float32)
    fj, ej, qj = je.EcsqTransport().fuse(jnp.asarray(f_p), jnp.float32(delta))
    ft, et, qt = te.EcsqTransport().fuse(torch.from_numpy(f_p),
                                         torch.tensor(delta))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-6)


def test_exact_fusion_and_batched_fuse():
    rng = np.random.default_rng(6)
    f_p = (rng.normal(size=(3, P, N)) * 0.3).astype(np.float32)
    fj, ej, qj = je.ExactFusion().fuse(jnp.asarray(f_p[0]), jnp.float32(0.1))
    ft, et, qt = te.ExactFusion().fuse(torch.from_numpy(f_p[0]),
                                       torch.tensor(0.1))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)
    assert float(et) == float(ej) == 0.0
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    # a batch of bin sizes, one lossless: each row == the unbatched call
    deltas = torch.tensor([0.05, np.inf, 0.01])
    fb, eb, qb = te.EcsqTransport().fuse(torch.from_numpy(f_p), deltas)
    for i in range(3):
        f1, e1, q1 = te.EcsqTransport().fuse(torch.from_numpy(f_p[i]),
                                             deltas[i])
        assert torch.equal(fb[i], f1) and torch.equal(qb[i], q1)
        assert float(eb[i]) == float(e1)


def test_interp_matches_numpy():
    rng = np.random.default_rng(7)
    xp = np.sort(rng.normal(size=40)).astype(np.float32)
    fp = rng.normal(size=40).astype(np.float32)
    x = np.concatenate([rng.uniform(xp[0] - 1, xp[-1] + 1, 200),
                        xp[[0, 7, 39]]]).astype(np.float32)
    got = te.interp(torch.from_numpy(x), torch.from_numpy(xp),
                    torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=1e-5, atol=1e-6)
    assert te.interp(torch.tensor(0.3), torch.from_numpy(xp),
                     torch.from_numpy(fp)).shape == ()


def test_bt_tables_built_independently_agree(bt_pair):
    """Same numpy table build on both sides: the 16 arrays are equal."""
    jbt, tbt = bt_pair
    assert te.BTTables._fields == je.BTTables._fields
    for name, aj, at in zip(te.BTTables._fields, jbt.tables, tbt.tables):
        assert at.dtype == torch.float32, name
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj), err_msg=name)


def test_bt_delta_for_on_converted_tables(bt_pair):
    """The port's decision on the reference's own tables over a grid of
    (t, sigma2_hat): delta and rate to 1e-4 (80 float32 bisection steps
    through different log/exp implementations), scalar and batched."""
    jbt, _ = bt_pair
    tables = convert.bt_tables_from_arrays([np.asarray(v) for v in jbt.tables])
    ctrl = te.BTRateControl.from_tables(tables)
    assert (ctrl.n_iter, ctrl.n_proc) == (T, P)
    s2c = jbt.host.sigma2_c
    for t in range(T):
        grid = (s2c[t] * np.array([0.5, 0.9, 1.0, 1.02, 1.1, 2.0])).astype(np.float32)
        want = [jbt.delta_for(jnp.asarray(t), jnp.float32(s)) for s in grid]
        d_b, r_b = ctrl.delta_for(t, torch.from_numpy(grid))
        assert d_b.shape == r_b.shape == (len(grid),)
        for k, s in enumerate(grid):
            d1, r1 = te.bt_delta_for(tables, t, torch.tensor(s))
            np.testing.assert_allclose(float(d1), float(want[k][0]), rtol=1e-4)
            np.testing.assert_allclose(float(r1), float(want[k][1]), rtol=1e-4)
            np.testing.assert_allclose(float(d_b[k]), float(d1), rtol=1e-6)
            np.testing.assert_allclose(float(r_b[k]), float(r1), rtol=1e-6)


# ---------------------------------------------------------------------------
# whole solves against the JAX engine
# ---------------------------------------------------------------------------

SCHEDULES = {
    "lossless": [np.inf] * T,
    "fixed": [0.02] * T,
    "mixed": [np.inf, 0.05, 0.03, 0.02, np.inf, 0.01, 0.01, 0.005],
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_solve_fixed_schedules_match_jax(name, problem, priors):
    s0, a, y = problem
    deltas = SCHEDULES[name]
    want = j_engine(priors[0], je.FixedSchedule(deltas)).solve(y, a)
    got = t_engine(priors[1], convert.schedule_from_deltas(deltas)).solve(y, a)
    assert got.symbols.shape == (T, P, N) and got.xs.shape == (T, N)
    np.testing.assert_array_equal(got.deltas, np.asarray(want.deltas))
    np.testing.assert_allclose(got.extra_var, np.asarray(want.extra_var),
                               rtol=1e-6)
    assert np.all(np.isinf(got.rates))
    assert_traces_agree(want, got, s0)


def test_solve_lossless_exact_fusion_matches_jax(problem, priors):
    s0, a, y = problem
    want = j_engine(priors[0], None, je.ExactFusion()).solve(y, a)
    got = t_engine(priors[1], None, te.ExactFusion()).solve(y, a)
    assert assert_traces_agree(want, got, s0) == T   # never a differing cell


@pytest.mark.parametrize("a_dtype", ["bfloat16"])
def test_solve_bf16_a_matches_jax(a_dtype, problem, priors):
    """A stored in bfloat16 on both sides, float32 accumulation."""
    s0, a, y = problem
    want = j_engine(priors[0], None, je.ExactFusion(), a_dtype=a_dtype).solve(y, a)
    got = t_engine(priors[1], None, te.ExactFusion(), a_dtype=a_dtype).solve(y, a)
    assert_traces_agree(want, got, s0)


def test_solve_dp_schedule_matches_jax(problem, probs, priors, mm):
    """DP allocation + RD tables from the committed cache, built on each
    side; and the reference's schedule converted, which must be the same."""
    s0, a, y = problem
    jr, tr = jrd.RDModel(priors[0]), trd.RDModel(priors[1])
    jdp = jra.dp_allocate(probs[0], P, T, 2.0 * T, rd=jr, mmse_fn=mm)
    tdp = tra.dp_allocate(probs[1], P, T, 2.0 * T, rd=tr, mmse_fn=mm)
    js, ts = je.DPSchedule(jdp, jr, P), te.DPSchedule(tdp, tr, P)
    np.testing.assert_array_equal(ts.deltas, js.deltas)
    conv = convert.schedule_from_deltas(js.deltas, js.rates, js.sigma2_d)
    assert isinstance(conv, te.DPSchedule)
    np.testing.assert_array_equal(conv.deltas, ts.deltas)
    np.testing.assert_array_equal(conv.rates, ts.rates)
    want = j_engine(priors[0], js).solve(y, a)
    got = t_engine(priors[1], ts).solve(y, a)
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("tables_from", ["port", "reference"])
def test_solve_bt_matches_jax(tables_from, problem, priors, bt_pair):
    """BT rate control on the device tensors: with the port's own tables
    and with the reference's converted ones (so a disagreement could be
    placed in the table build or in ``bt_delta_for``)."""
    s0, a, y = problem
    jbt, tbt = bt_pair
    if tables_from == "reference":
        tbt = te.BTRateControl.from_tables(convert.bt_tables_from_arrays(
            {k: np.asarray(v) for k, v in zip(je.BTTables._fields, jbt.tables)}))
    want = j_engine(priors[0], jbt).solve(y, a)
    got = t_engine(priors[1], tbt).solve(y, a)
    assert np.all(np.isfinite(got.rates)) and np.all(got.rates <= 6.0 + 1e-4)
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_bt_decisions_lockstep_with_jax_trajectory(seed, priors, bt_pair):
    """Whatever the quantization noise does to the rest of a run, each BT
    decision is a function of (t, sigma2_hat) alone: fed the reference's
    realised sigma2_hat, the port reproduces its bin sizes and rates."""
    s0, a, y = make_problem(seed)
    jbt, tbt = bt_pair
    want = j_engine(priors[0], jbt).solve(y, a)
    for t in range(T):
        d, r = tbt.delta_for(t, torch.tensor(float(want.sigma2_hat[t])))
        np.testing.assert_allclose(float(d), float(want.deltas[t]), rtol=1e-4)
        np.testing.assert_allclose(float(r), float(want.rates[t]), rtol=1e-4)


def test_convert_problem_shards_and_fields(problem, priors, probs):
    """``convert.py``: the reference's problem, pre-split shards and
    dataclasses, handed over as numpy / plain values, give the port the
    same solve as handing it the arrays directly."""
    s0, a, y = problem
    jp, jprob = priors[0], probs[0]
    prior = convert.prior_from_fields(jp.eps, jp.mu_s, jp.sigma_s)
    prob = convert.problem_from_fields(jprob.n, jprob.m, jp.eps, jp.mu_s,
                                       jp.sigma_s, jprob.snr_db)
    assert prior == priors[1] and prob == probs[1]
    assert prob.sigma_e2 == jprob.sigma_e2
    a_t, y_t = convert.problem_to_torch(a, y, device="cpu")
    assert a_t.dtype == y_t.dtype == torch.float32
    np.testing.assert_array_equal(a_t.numpy(), a)
    ja_p, jy_p = je.split_problem(a, y, P)
    for a_dtype in ("float32", "bfloat16"):
        a_p, y_p = convert.shards_to_torch(np.asarray(ja_p), np.asarray(jy_p),
                                           device="cpu", a_dtype=a_dtype)
        assert a_p.dtype == getattr(torch, a_dtype) and a_p.is_contiguous()
        assert a_p.shape == (P, M // P, N) and y_p.shape == (P, M // P)
        eng = t_engine(prior, te.FixedSchedule(SCHEDULES["fixed"]),
                       a_dtype=a_dtype)
        x, outs = eng.dispatch_single(a_p, y_p, M, N)
        direct = eng.solve(y_t, a_t)
        np.testing.assert_array_equal(x.numpy(), direct.x)
        np.testing.assert_array_equal(outs.s2.numpy(), direct.sigma2_hat)
        # a schedule passed as the operand overrides the controller's
        x2, outs2 = eng.dispatch_single(a_p, y_p, M, N,
                                        sched=np.full(T, np.inf, np.float32))
        assert np.all(np.isinf(outs2.deltas.numpy()))
        assert float(outs2.extra.abs().max()) == 0.0
    assert eng.dispatch_count == 3


# ---------------------------------------------------------------------------
# the port against itself and against theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_a", [False, True], ids=["per_instance_a", "shared_a"])
@pytest.mark.parametrize("ctrl", ["fixed", "bt"])
def test_solve_many_equals_per_instance_solve(shared_a, ctrl, priors, bt_pair):
    b = 3
    probs_ = [make_problem(20 + i) for i in range(b)]
    a0 = probs_[0][1]
    if shared_a:   # same A, different signals and noise
        rng = np.random.default_rng(99)
        sig = np.sqrt(tse.CSProblem(N, M, priors[1]).sigma_e2)
        probs_ = [(s0, a0, (a0 @ s0 + sig * rng.normal(size=M)).astype(np.float32))
                  for s0, _, _ in probs_]
    controller = te.FixedSchedule([np.inf, 0.02, 0.02, 0.01, 0.01, 0.01,
                                   0.005, 0.005]) if ctrl == "fixed" else bt_pair[1]
    eng = t_engine(priors[1], controller)
    ys = np.stack([p[2] for p in probs_])
    a_in = a0 if shared_a else np.stack([p[1] for p in probs_])
    many = eng.solve_many(ys, a_in)
    assert many.x.shape == (b, N) and many.sigma2_hat.shape == (b, T)
    assert many.xs.shape == (b, T, N) and many.symbols.shape == (b, T, P, N)
    for i, (s0, a, y) in enumerate(probs_):
        one = eng.solve(y, a)
        sub = te.EngineTrace(*(None if v is None else v[i] for v in (
            many.x, many.sigma2_hat, many.deltas, many.extra_var, many.rates,
            many.symbols, many.xs)))
        assert_traces_agree(one, sub, s0)
    assert eng.dispatch_count == 1 + b


@pytest.mark.parametrize("ctrl", ["fixed", "bt"])
def test_solve_equals_host_loop(ctrl, problem, priors, bt_pair):
    """The sync-free loop and the per-iteration host loop run the same
    tensor ops in the same order."""
    s0, a, y = problem
    controller = te.FixedSchedule(SCHEDULES["mixed"]) if ctrl == "fixed" \
        else bt_pair[1]
    eng = t_engine(priors[1], controller)
    scan, host = eng.solve(y, a), eng.solve_host_loop(y, a)
    assert_traces_agree(scan, host, s0, check_deltas=False)
    np.testing.assert_allclose(host.deltas, scan.deltas, rtol=1e-6)
    np.testing.assert_allclose(host.x, scan.x, atol=1e-6)


@pytest.mark.parametrize("n_proc", [1, 4, 6])
def test_centralized_equals_lossless_mp_amp(n_proc, problem, priors):
    s0, a, y = problem
    cen = tamp.amp_solve(y, a, priors[1], T, s0=s0, device="cpu")
    mp = tmp.mp_amp_solve(y, a, priors[1],
                          tmp.MPAMPConfig(n_proc, T, device="cpu"),
                          [np.inf] * T, s0=s0)
    np.testing.assert_allclose(mp.x, cen.x, atol=1e-5)
    np.testing.assert_allclose(mp.sigma2_hat, cen.sigma2_hat, rtol=1e-5)
    # and the centralized frontend against the JAX one
    jcen = jamp.amp_solve(y, a, priors[0], T, s0=s0)
    np.testing.assert_allclose(cen.x, jcen.x, atol=1e-4)
    np.testing.assert_allclose(cen.mse, jcen.mse, rtol=1e-3)


def test_amp_iteration_matches_jax(problem, priors):
    s0, a, y = problem
    rng = np.random.default_rng(8)
    x = (s0 + 0.05 * rng.normal(size=N)).astype(np.float32)
    z = (y - a @ x).astype(np.float32)
    want = jamp.amp_iteration(jnp.asarray(x), jnp.asarray(z), jnp.asarray(y),
                              jnp.asarray(a), priors[0])
    got = tamp.amp_iteration(*map(torch.from_numpy, (x, z, y, a)), priors[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_amp_matches_state_evolution():
    """Finite-N AMP tracks the SE prediction (paper eq. 4), with the bands
    of the JAX package's own test (tests/test_amp_and_mp_amp.py): a
    one-iteration lag band and a plateau check. N=2000 here."""
    n, m, t = 2000, 600, 15
    prior = td.BernoulliGauss(EPS)
    prob = tse.CSProblem(n=n, m=m, prior=prior)
    s0, a, y = make_problem(0, n, m)
    tr = tamp.amp_solve(y, a, prior, t, s0=s0, device="cpu")
    se = tse.se_trajectory(prob, t)
    se_mse = prob.kappa * (se[1:] - prob.sigma_e2)
    lo = 0.6 * np.minimum.reduce([se_mse, np.append(se_mse[1:], se_mse[-1])])
    hi = 1.7 * np.maximum.reduce([se_mse, np.insert(se_mse[:-1], 0, se_mse[0])])
    assert np.all(tr.mse >= lo) and np.all(tr.mse <= hi), tr.mse / se_mse
    assert 0.65 < tr.mse[-1] / se_mse[-1] < 1.6
    # the plug-in estimate starts at ||y||^2 / M (z_0 = y) and ends within
    # the same plateau band around the SE fixed point
    np.testing.assert_allclose(tr.sigma2_hat[0], np.mean(y * y), rtol=1e-5)
    excess = (tr.sigma2_hat[-1] - prob.sigma_e2) / (se[t - 1] - prob.sigma_e2)
    assert 0.65 < excess < 1.6, excess


def test_sample_problem_statistics():
    """The port's own generator draws the paper's model (it does not draw
    the JAX generator's numbers, so only statistics are checked)."""
    prior = td.BernoulliGauss(0.1)
    s0, a, y = tamp.sample_problem(3, 4000, 1200, prior, 0.01, device="cpu")
    assert s0.shape == (4000,) and a.shape == (1200, 4000) and y.shape == (1200,)
    assert abs(float((s0 != 0).float().mean()) - 0.1) < 0.02
    assert abs(float(a.var()) * 1200 - 1.0) < 0.01
    resid = y - a @ s0
    assert abs(float(resid.var()) / 0.01 - 1.0) < 0.15
    s0b, ab, yb = tamp.sample_problem(3, 4000, 1200, prior, 0.01, device="cpu")
    assert torch.equal(s0, s0b) and torch.equal(a, ab) and torch.equal(y, yb)
