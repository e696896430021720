"""The column layout (C-MP-AMP) of the port's engine against the JAX
engine, on the CPU.

Inputs are made with numpy from a seed and handed to both sides, at the
reference's golden point (N=2000, M=600, eps=0.05, 20 dB). The port runs
with ``device="cpu"`` (plain versions of its kernels); the JAX engine runs
its jnp path and, where said, its Pallas kernels in interpret mode.

Tolerances. A lossless solve is float32 on both sides with sums in another
order: x and ``sigma2_hat`` agree to 1e-5 relative (x relative to max|x|).
Quantized solves (fixed Δ, ColDPSchedule, column BT, int8/int4 blocks) are
discontinuous and are held by ``test_torch_engine.assert_traces_agree``.
The reference's own ``test_column_multi_inner_rounds`` is red on this tree
(its bound of 3.0 against a measured 3.40, the same on both sides): the
port's ``n_inner = 2`` solve is held to parity with the reference on the
same data here, and to the envelope of the reference's column SE oracle in
the tier-2 test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.core.engine as je
import repro.core.rate_alloc as jra
import repro.core.state_evolution as jse
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
import repro_torch.core.rate_alloc as tra
import repro_torch.core.state_evolution as tse
from repro_torch import convert
from test_torch_engine import assert_traces_agree

N, M, EPS, T = 2000, 600, 0.05, 10


def make_problem(seed, n=N, m=M, eps=EPS):
    rng = np.random.default_rng(seed)
    prob = tse.CSProblem(n=n, m=m, prior=td.BernoulliGauss(eps), snr_db=20.0)
    s0 = ((rng.random(n) < eps) * rng.normal(size=n)).astype(np.float32)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)).astype(np.float32)
    return s0, a, y


@pytest.fixture(scope="module")
def problem():
    return make_problem(0)


@pytest.fixture(scope="module")
def probs():
    return (jse.CSProblem(N, M, jd.BernoulliGauss(EPS), 20.0),
            tse.CSProblem(N, M, td.BernoulliGauss(EPS), 20.0))


@pytest.fixture(scope="module")
def mm():
    return td.make_mmse_interp(td.BernoulliGauss(EPS), n_grid=100)


@pytest.fixture(scope="module")
def bt_pair(probs, mm):
    """Column BT controllers built independently on both sides."""
    return (je.ColumnBTRateControl(probs[0], 4, T, 1.05, 6.0, mmse_fn=mm),
            te.ColumnBTRateControl(probs[1], 4, T, 1.05, 6.0, mmse_fn=mm))


def j_col(p, transport=None, ctrl=None, n_iter=T, n_inner=1, **kw):
    return je.AmpEngine(
        jd.BernoulliGauss(EPS),
        je.EngineConfig(n_proc=p, n_iter=n_iter,
                        layout=je.ColumnPartition(n_inner), **kw),
        transport or je.ExactFusion(), ctrl)


def t_col(p, transport=None, ctrl=None, n_iter=T, n_inner=1, **kw):
    return te.AmpEngine(
        td.BernoulliGauss(EPS),
        te.EngineConfig(n_proc=p, n_iter=n_iter, device="cpu",
                        layout=te.ColumnPartition(n_inner), **kw),
        transport or te.ExactFusion(), ctrl)


def _lossless_agree(want, got):
    dx = np.abs(got.x - np.asarray(want.x)).max() / np.abs(want.x).max()
    assert dx <= 1e-5, dx
    np.testing.assert_allclose(got.sigma2_hat, np.asarray(want.sigma2_hat),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_split_problem_cols_matches_reference(problem):
    _, a, _ = problem
    want = je.split_problem_cols(a, 8)
    np.testing.assert_array_equal(te.split_problem_cols(a, 8), want)
    got = te.split_problem_cols(torch.from_numpy(a), 8)
    assert got.shape == (8, M, N // 8) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    batch = te.split_problem_cols(torch.from_numpy(np.stack([a, 2 * a])), 8)
    assert batch.shape == (2, 8, M, N // 8)
    np.testing.assert_array_equal(batch[1].numpy(), 2 * want)
    assert te.ColumnPartition().carry_fused
    assert not te.ColumnPartition(n_inner=2).carry_fused
    assert te.EngineConfig(layout=te.ColumnPartition()).is_col
    assert not te.EngineConfig().is_col


def test_col_bt_tables_built_independently_agree(bt_pair):
    """Same numpy table build on both sides: the 14 arrays agree to 1e-6."""
    jbt, tbt = bt_pair
    assert te.ColBTTables._fields == je.ColBTTables._fields
    for name, aj, at in zip(te.ColBTTables._fields, jbt.tables, tbt.tables):
        assert at.dtype == torch.float32, name
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6,
                                   err_msg=name)


def test_col_bt_delta_for_on_converted_tables(bt_pair):
    """The port's closed-form decision on the reference's own tables over a
    grid of (round, v_hat): delta and rate to 1e-5, scalar and batched;
    round 0 is free (inf, 0)."""
    jbt, _ = bt_pair
    tables = convert.col_bt_tables_from_arrays(
        {k: np.asarray(v) for k, v in zip(je.ColBTTables._fields, jbt.tables)})
    ctrl = te.ColumnBTRateControl.from_tables(tables)
    assert (ctrl.n_iter, ctrl.n_proc) == (T, 4)
    targets = np.asarray(jbt.tables.targets)
    for t in range(T):
        grid = (targets[t] / 1.05 * np.array([0.5, 0.9, 1.0, 1.1, 3.0])
                ).astype(np.float32)
        d_b, r_b = ctrl.delta_for(t, torch.from_numpy(grid))
        assert d_b.shape == r_b.shape == (len(grid),)
        for i, v in enumerate(grid):
            dj, rj = je.col_bt_delta_for(jbt.tables, t, jnp.float32(v))
            d1, r1 = te.col_bt_delta_for(tables, t, torch.tensor(v))
            if t == 0:
                assert np.isinf(float(d1)) and float(r1) == 0.0
            np.testing.assert_allclose(float(d1), float(dj), rtol=1e-5)
            np.testing.assert_allclose(float(r1), float(rj), rtol=1e-5)
            assert float(d_b[i]) == float(d1) and float(r_b[i]) == float(r1)


def test_col_dp_schedule_built_and_converted_agree(probs, mm):
    jdp = jra.dp_allocate_col(probs[0], 4, T, 20.0, mmse_fn=mm)
    tdp = tra.dp_allocate_col(probs[1], 4, T, 20.0, mmse_fn=mm)
    js, ts = je.ColDPSchedule(jdp, probs[0], 4), te.ColDPSchedule(tdp, probs[1], 4)
    np.testing.assert_array_equal(ts.deltas, js.deltas)
    assert np.isinf(ts.deltas[0]) and np.all(np.isfinite(ts.deltas[1:]))
    conv = convert.col_dp_schedule_from_arrays(js.deltas, js.rates, js.d_traj)
    assert isinstance(conv, te.ColDPSchedule)
    np.testing.assert_array_equal(conv.deltas, ts.deltas)
    np.testing.assert_array_equal(conv.d_traj, ts.d_traj)


# ---------------------------------------------------------------------------
# whole column solves against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 8])
def test_column_exact_matches_reference_and_centralized(p, problem):
    """Lossless C-MP-AMP at n_inner = 1 against the reference's jnp path and
    its Pallas path in interpret mode; and against the port's own
    single-processor solve, which it equals (MSE <= 1e-10, as the
    reference pins it)."""
    s0, a, y = problem
    got = t_col(p).solve(y, a)
    assert got.symbols.shape == (T, p, M) and got.xs.shape == (T, N)
    _lossless_agree(j_col(p).solve(y, a), got)
    _lossless_agree(j_col(p, use_kernel=True, kernel_interpret=True)
                    .solve(y, a), got)
    single = te.AmpEngine(td.BernoulliGauss(EPS),
                          te.EngineConfig(n_proc=1, n_iter=T, device="cpu"),
                          te.ExactFusion()).solve(y, a)
    assert float(np.mean((got.x - single.x) ** 2)) <= 1e-10
    np.testing.assert_allclose(got.sigma2_hat, single.sigma2_hat, rtol=1e-5)
    assert float(got.mse(s0)[-1]) < 5e-4


def test_column_two_inner_matches_reference(problem):
    """n_inner = 2, five rounds: parity with the reference on the same
    data (jnp and interpret paths); the MSE falls every round."""
    s0, a, y = problem
    got = t_col(4, n_iter=5, n_inner=2).solve(y, a)
    _lossless_agree(j_col(4, n_iter=5, n_inner=2).solve(y, a), got)
    _lossless_agree(j_col(4, n_iter=5, n_inner=2, use_kernel=True,
                          kernel_interpret=True).solve(y, a), got)
    assert np.all(np.diff(got.mse(s0)) < 0)


def test_red_reference_multi_inner_ratio_is_the_ports():
    """The reference's red ``test_column_multi_inner_rounds`` on its own
    data (``PRNGKey(0)`` golden point): 5 rounds x 2 inner iterations
    against 10 lossless rounds give the same final-MSE ratio on both sides
    (about 3.40 where that test asks for < 3.0), so the bound, not the
    port, is what disagrees. ``-s`` prints the ratios."""
    import jax
    from repro.core.amp import sample_problem
    prob = jse.CSProblem(N, M, jd.BernoulliGauss(EPS), 20.0)
    s0, a, y = map(np.asarray, sample_problem(
        jax.random.PRNGKey(0), N, M, prob.prior, prob.sigma_e2))
    ratio = {}
    for side, make in (("reference", j_col), ("port", t_col)):
        ten = make(4, collect_symbols=False).solve(y, a)
        two = make(4, n_iter=5, n_inner=2, collect_symbols=False).solve(y, a)
        ratio[side] = float(two.mse(s0)[-1]) / float(ten.mse(s0)[-1])
        assert np.all(np.diff(two.mse(s0)) < 0), side
    print("final-MSE ratio, 5x2 inner vs 10 lossless rounds:", ratio)
    np.testing.assert_allclose(ratio["port"], ratio["reference"], rtol=1e-4)


def test_column_bf16_a_matches_reference(problem):
    s0, a, y = problem
    want = j_col(4, a_dtype="bfloat16").solve(y, a)
    got = t_col(4, a_dtype="bfloat16").solve(y, a)
    _lossless_agree(want, got)
    f32 = t_col(4).solve(y, a)
    mse16, mse32 = float(got.mse(s0)[-1]), float(f32.mse(s0)[-1])
    assert abs(mse16 - mse32) <= 0.01 * mse32


@pytest.mark.parametrize("round0", [np.inf, 0.02])
def test_column_ecsq_fixed_matches_reference(round0, problem):
    """ECSQ on the exchanged residuals at a fixed bin: the noise accounting
    is exactly P Delta^2 / 12 from round 1 on and 0 at round 0, whatever
    bin round 0 names (its contributions are all zero)."""
    s0, a, y = problem
    deltas = np.full(T, 0.02, np.float32)
    deltas[0] = round0
    want = j_col(4, je.EcsqTransport(), je.FixedSchedule(deltas)).solve(y, a)
    got = t_col(4, te.EcsqTransport(), te.FixedSchedule(deltas)).solve(y, a)
    assert got.extra_var[0] == 0.0
    np.testing.assert_allclose(got.extra_var[1:], 4 * 0.02**2 / 12.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.extra_var, np.asarray(want.extra_var))
    assert_traces_agree(want, got, s0)


def test_column_dp_schedule_matches_reference(problem, probs, mm):
    s0, a, y = problem
    jdp = jra.dp_allocate_col(probs[0], 4, T, 20.0, mmse_fn=mm)
    js = je.ColDPSchedule(jdp, probs[0], 4)
    ts = te.ColDPSchedule(tra.dp_allocate_col(probs[1], 4, T, 20.0,
                                              mmse_fn=mm), probs[1], 4)
    want = j_col(4, je.EcsqTransport(), js).solve(y, a)
    got = t_col(4, te.EcsqTransport(), ts).solve(y, a)
    assert np.all(np.isinf(got.rates))
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("tables_from", ["port", "reference"])
def test_column_bt_matches_reference(tables_from, problem, bt_pair):
    """Column BT on device tensors, with the port's own tables and with the
    reference's converted ones: round 0 free, later rates in (0, r_max]."""
    s0, a, y = problem
    jbt, tbt = bt_pair
    if tables_from == "reference":
        tbt = te.ColumnBTRateControl.from_tables(
            convert.col_bt_tables_from_arrays([np.asarray(v)
                                               for v in jbt.tables]))
    want = j_col(4, je.EcsqTransport(), jbt).solve(y, a)
    got = t_col(4, te.EcsqTransport(), tbt).solve(y, a)
    assert np.isinf(got.deltas[0]) and got.rates[0] == 0.0
    assert np.all(np.isfinite(got.deltas[1:]))
    assert np.all((got.rates[1:] > 0) & (got.rates[1:] <= 6.0 + 1e-5))
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("bits,block", [(8, 512), (4, 256)])
def test_column_block_quant_matches_reference(bits, block, problem):
    """int8 / int4 blocks on the residual exchange: round 0's all-zero
    contributions inject nothing; traces agree with the reference."""
    s0, a, y = problem
    want = j_col(4, je.BlockQuantTransport(bits, block)).solve(y, a)
    got = t_col(4, te.BlockQuantTransport(bits, block)).solve(y, a)
    assert got.extra_var[0] == 0.0 and np.all(got.extra_var[1:] > 0)
    assert got.symbols.shape == (T, 4, M) and not got.symbols[0].any()
    assert_traces_agree(want, got, s0)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_a", [False, True], ids=["per_instance_a", "shared_a"])
@pytest.mark.parametrize("ctrl", ["lossless", "bt"])
def test_column_solve_many_equals_solve(shared_a, ctrl, problem, bt_pair):
    b = 3
    insts = [make_problem(30 + i) for i in range(b)]
    if shared_a:   # same A, other signals and noise
        a0 = insts[0][1]
        rng = np.random.default_rng(99)
        sig = np.sqrt(tse.CSProblem(N, M, td.BernoulliGauss(EPS), 20.0).sigma_e2)
        insts = [(s0, a0, (a0 @ s0 + sig * rng.normal(size=M)).astype(np.float32))
                 for s0, _, _ in insts]
    transport, controller = (te.ExactFusion(), None) if ctrl == "lossless" \
        else (te.EcsqTransport(), bt_pair[1])
    eng = t_col(4, transport, controller)
    ys = np.stack([i[2] for i in insts])
    a_in = insts[0][1] if shared_a else np.stack([i[1] for i in insts])
    many = eng.solve_many(ys, a_in)
    assert many.x.shape == (b, N) and many.symbols.shape == (b, T, 4, M)
    for i, (s0, a, y) in enumerate(insts):
        one = eng.solve(y, a)
        sub = te.EngineTrace(*(None if v is None else v[i] for v in (
            many.x, many.sigma2_hat, many.deltas, many.extra_var, many.rates,
            many.symbols, many.xs)))
        assert_traces_agree(one, sub, s0)
    assert eng.dispatch_count == 1 + b


def test_column_rejects_row_controller_and_row_entry_points(problem, probs):
    """A row-wise BT controller predicts through the wrong SE: refused, as
    the reference refuses it. The row-only entry points refuse the column
    layout; column BT refuses n_inner > 1."""
    _, a, y = problem
    ctrl = te.BTRateControl(probs[1], 4, 8, 1.005, 6.0, "ecsq",
                            n_s2_grid=4, n_u_grid=7)
    with pytest.raises(TypeError, match="ColumnBTRateControl"):
        t_col(4, te.EcsqTransport(), ctrl, n_iter=8).solve(y, a)
    with pytest.raises(TypeError, match="ColumnBTRateControl"):
        t_col(4, te.EcsqTransport(), ctrl, n_iter=8).solve_many(y[None], a)
    eng = t_col(4)
    with pytest.raises(ValueError, match="row-layout"):
        eng.dispatch_single(a, y, M, N)
    with pytest.raises(ValueError, match="row-layout"):
        eng.solve_host_loop(y, a)
    with pytest.raises(ValueError, match="n_inner"):
        te.ColumnBTRateControl(probs[1], 4, T, n_inner=2)


# ---------------------------------------------------------------------------
# tier 2: the reference's column SE oracle, run on the port
# ---------------------------------------------------------------------------

@pytest.mark.tier2
def test_column_two_inner_tracks_two_stage_se():
    """The port's n_inner = 2 solves (24 instances, P=4, 6 rounds) within
    the envelope the reference's ``test_se_oracle_col`` calibrated for the
    two-stage column SE; and two inner iterations beat one."""
    p, b, rounds = 4, 24, 6
    rel_tol = np.array([0.25, 0.45, 0.60, 0.70, 0.65, 0.55])
    prob = tse.CSProblem(n=N, m=M, prior=td.BernoulliGauss(EPS), snr_db=20.0)
    insts = [make_problem(100 + i) for i in range(b)]
    s0s = np.stack([i[0] for i in insts])
    a_mats = np.stack([i[1] for i in insts])
    ys = np.stack([i[2] for i in insts])
    mm = td.make_mmse_interp(prob.prior)
    mc = t_col(p, n_iter=rounds, n_inner=2, collect_symbols=False) \
        .solve_many(ys, a_mats).mse(s0s).mean(axis=0)
    _, d = tse.se_trajectory_col(prob, p, rounds, 2, mmse_fn=mm)
    rel = np.abs(mc - d[1:]) / d[1:]
    assert (rel < rel_tol).all(), list(zip(rel, rel_tol))
    mc1 = t_col(p, n_iter=rounds, collect_symbols=False) \
        .solve_many(ys, a_mats).mse(s0s).mean(axis=0)
    _, d1 = tse.se_trajectory_col(prob, p, rounds, 1, mmse_fn=mm)
    assert mc[-1] < mc1[-1] and d[-1] < d1[-1]
