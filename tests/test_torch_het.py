"""The heterogeneous batch solve of the port (``AmpEngine.solve_het``)
against the JAX engine's, on the CPU.

Each test makes its operands with numpy from a seed: B padded instances
with their own prior, SNR, iteration budget, real N and M and rate policy
(lossless, fixed ECSQ schedule, BT). Both engines get the same numpy
arrays; the BT tables are built once by the reference and carried across
(``convert.het_params_from_arrays``), so both sides decide from the same
tables.

Tolerances. A lossless instance is held to rtol 1e-5 on ``sigma2_hat``,
the bins and the rates, and its final x to 1e-4 of its scale (max |x|),
the whole-solve bound of ``test_torch_engine.py``: float32 sums in other
orders over up to 8 iterations move single entries of x by ~1e-5 of the
scale (seen: 1.1e-5 on one entry of 448). A quantized instance (fixed
schedule or BT) is held to the same while its symbols agree with the
reference's and by ``assert_traces_agree`` (the
module docstring of ``test_torch_engine.py``) from the first iteration
where a quantizer cell differs. The stacked BT lookups equal the
per-instance shared-table calls bit for bit (the same elementwise
arithmetic) and the reference's decisions within 1e-4, the bound of the
shared-table tests. The masked early exit is exact: an instance frozen at
its budget carries the bits of a batch that stopped there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.core.engine as je
import repro.core.rate_alloc as jra
import repro.core.state_evolution as jse
import repro.kernels.amp_fused.ops as jops
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
from repro_torch import convert
from repro_torch.kernels.amp_fused import ops as tops
from repro_torch.kernels.amp_fused.ref import col_inner_step_ref, col_params

from test_torch_engine import assert_traces_agree

P = 4
T_MAX = 8
N_S2, N_U, N_U_COL = 6, 11, 16    # small BT grids: quick to build

# (n, m, eps, snr_db, T, policy) per instance
ROW_SPECS = [(500, 160, 0.10, 20.0, 6, "lossless"),
             (512, 192, 0.05, 15.0, 8, "fixed"),
             (448, 144, 0.10, 15.0, 5, "bt"),
             (480, 176, 0.05, 20.0, 7, "fixed")]
COL_SPECS = [(512, 128, 0.10, 20.0, 8, "lossless"),
             (480, 120, 0.05, 15.0, 6, "bt"),
             (448, 112, 0.10, 20.0, 7, "fixed")]


def _instance(seed, n, m, eps, snr):
    rng = np.random.default_rng(seed)
    prob = jse.CSProblem(n=n, m=m, prior=jd.BernoulliGauss(eps), snr_db=snr)
    s0 = ((rng.random(n) < eps) * rng.normal(size=n)).astype(np.float32)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)
         ).astype(np.float32)
    return prob, s0, a, y


def _schedule(policy, t):
    if policy == "fixed":
        d = np.full(t, 0.04, np.float32)
        d[0] = np.inf
        return d
    return np.full(t, np.inf, np.float32)


def _params(specs, probs, col):
    """The reference's HetParams (numpy arrays) and the port's, from it."""
    tables = []
    for (n, m, eps, snr, t, policy), prob in zip(specs, probs):
        if policy != "bt":
            tables.append(je.ColBTTables.dummy(T_MAX, n_u=N_U_COL) if col
                          else je.BTTables.dummy(T_MAX, N_S2, N_U))
        elif col:
            tables.append(je.pad_bt_tables(je.ColumnBTRateControl(
                prob, P, t, 1.05, 6.0, n_u_grid=N_U_COL).tables, T_MAX))
        else:
            tables.append(je.pad_bt_tables(je.BTRateControl(
                prob, P, t, 1.005, 6.0, "ecsq", n_s2_grid=N_S2,
                n_u_grid=N_U).tables, T_MAX))
    hp = je.HetParams(
        sched=jra.stack_schedules([_schedule(s[-1], s[4]) for s in specs],
                                  T_MAX),
        t_active=np.asarray([s[4] for s in specs], np.int32),
        m_real=np.asarray([s[1] for s in specs], np.float32),
        n_real=np.asarray([s[0] for s in specs], np.int32),
        eps=np.asarray([s[2] for s in specs], np.float32),
        mu_s=np.zeros(len(specs), np.float32),
        sigma_s=np.ones(len(specs), np.float32),
        use_bt=np.asarray([s[-1] == "bt" for s in specs]),
        bt=je.stack_bt_tables(tables))
    hp = jax.tree.map(np.asarray, hp)
    return hp, convert.het_params_from_arrays(hp)


def _row_batch(specs, seed=0):
    mp_pad = max(m // P for _, m, *_ in specs)
    n_pad = max(n for n, *_ in specs)
    b = len(specs)
    a_b = np.zeros((b, P, mp_pad, n_pad), np.float32)
    y_b = np.zeros((b, P, mp_pad), np.float32)
    probs, s0s = [], []
    for i, (n, m, eps, snr, _, _) in enumerate(specs):
        prob, s0, a, y = _instance(seed + i, n, m, eps, snr)
        a_b[i, :, :m // P, :n] = a.reshape(P, m // P, n)
        y_b[i, :, :m // P] = y.reshape(P, m // P)
        probs.append(prob)
        s0s.append(s0)
    return a_b, y_b, probs, s0s


def _col_batch(specs, seed=10):
    np_pad = max(n // P for n, *_ in specs)
    m_pad = max(m for _, m, *_ in specs)
    b = len(specs)
    a_b = np.zeros((b, P, m_pad, np_pad), np.float32)
    y_b = np.zeros((b, m_pad), np.float32)
    probs, s0s = [], []
    for i, (n, m, eps, snr, _, _) in enumerate(specs):
        prob, s0, a, y = _instance(seed + i, n, m, eps, snr)
        a_b[i, :, :m, :n // P] = je.split_problem_cols(a, P)
        y_b[i, :m] = y
        probs.append(prob)
        s0s.append(s0)
    return a_b, y_b, probs, s0s


def _engines(col):
    layout = dict(layout=je.ColumnPartition(1)) if col else {}
    t_layout = dict(layout=te.ColumnPartition(1)) if col else {}
    jeng = je.AmpEngine(jd.BernoulliGauss(), je.EngineConfig(
        n_proc=P, n_iter=T_MAX, collect_xs=True, **layout), je.EcsqTransport())
    teng = te.AmpEngine(td.BernoulliGauss(), te.EngineConfig(
        n_proc=P, n_iter=T_MAX, collect_xs=True, device="cpu", **t_layout),
        te.EcsqTransport())
    return jeng, teng


def _unpad_x(x, n, n_pad, col):
    if col:
        return x.reshape(P, n_pad // P)[:, :n // P].reshape(-1)
    return x[:n]


def _instance_trace(tr, i, n, t, n_pad, col):
    """Instance i of a het trace, unpadded to its own N and T."""
    un = lambda v: _unpad_x(v, n, n_pad, col)
    return te.EngineTrace(
        x=un(np.asarray(tr.x)[i]),
        sigma2_hat=np.asarray(tr.sigma2_hat)[i, :t],
        deltas=np.asarray(tr.deltas)[i, :t],
        extra_var=np.asarray(tr.extra_var)[i, :t],
        rates=np.asarray(tr.rates)[i, :t],
        symbols=np.asarray(tr.symbols)[i, :t],
        xs=np.stack([un(v) for v in np.asarray(tr.xs)[i, :t]]))


def _check(want, got, s0, quantized):
    """Lossless, or quantized with every symbol the same: rtol 1e-5.
    Otherwise ``assert_traces_agree``."""
    same_symbols = np.array_equal(want.symbols, got.symbols)
    if not quantized or same_symbols:
        np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.deltas, want.deltas, rtol=1e-5)
        np.testing.assert_allclose(got.x, want.x, rtol=0,
                                   atol=1e-4 * np.abs(want.x).max())
        np.testing.assert_array_equal(np.isinf(got.rates),
                                      np.isinf(want.rates))
        fin = np.isfinite(want.rates)
        np.testing.assert_allclose(got.rates[fin], want.rates[fin],
                                   rtol=1e-5)
        return
    assert_traces_agree(want, got, s0)


@pytest.fixture(scope="module")
def row_case():
    a_b, y_b, probs, s0s = _row_batch(ROW_SPECS)
    j_hp, t_hp = _params(ROW_SPECS, probs, col=False)
    jeng, teng = _engines(col=False)
    return (jeng.solve_het(a_b, y_b, j_hp), teng.solve_het(a_b, y_b, t_hp),
            s0s, a_b.shape[-1])


@pytest.fixture(scope="module")
def col_case():
    a_b, y_b, probs, s0s = _col_batch(COL_SPECS)
    j_hp, t_hp = _params(COL_SPECS, probs, col=True)
    jeng, teng = _engines(col=True)
    return (jeng.solve_het(a_b, y_b, j_hp), teng.solve_het(a_b, y_b, t_hp),
            s0s, P * a_b.shape[-1])


@pytest.mark.parametrize("i", range(len(ROW_SPECS)),
                         ids=[f"{s[-1]}{i}" for i, s in enumerate(ROW_SPECS)])
def test_row_bucket_matches_reference(row_case, i):
    want, got, s0s, n_pad = row_case
    n, m, eps, snr, t, policy = ROW_SPECS[i]
    w = _instance_trace(want, i, n, t, n_pad, col=False)
    g = _instance_trace(got, i, n, t, n_pad, col=False)
    _check(w, g, s0s[i], quantized=policy != "lossless")
    # frozen past its budget: zero record, infinite rate
    assert np.all(np.asarray(got.sigma2_hat)[i, t:] == 0.0)
    assert np.all(np.isinf(np.asarray(got.rates)[i, t:]))
    # padded columns stay exactly zero
    assert np.all(np.asarray(got.x)[i, n:] == 0.0)


@pytest.mark.parametrize("i", range(len(COL_SPECS)),
                         ids=[f"{s[-1]}{i}" for i, s in enumerate(COL_SPECS)])
def test_col_bucket_matches_reference(col_case, i):
    want, got, s0s, n_pad = col_case
    n, m, eps, snr, t, policy = COL_SPECS[i]
    w = _instance_trace(want, i, n, t, n_pad, col=True)
    g = _instance_trace(got, i, n, t, n_pad, col=True)
    _check(w, g, s0s[i], quantized=policy != "lossless")
    assert np.all(np.asarray(got.sigma2_hat)[i, t:] == 0.0)
    x = np.asarray(got.x)[i].reshape(P, -1)
    assert np.all(x[:, n // P:] == 0.0)


def _tables(col):
    """Three instances' BT tables of one kind, built by the reference."""
    out = []
    for k, (eps, snr) in enumerate([(0.1, 20.0), (0.05, 15.0), (0.1, 25.0)]):
        prob = jse.CSProblem(n=512, m=160 - 16 * k, prior=jd.BernoulliGauss(eps),
                             snr_db=snr)
        if col:
            tb = je.ColumnBTRateControl(prob, P, T_MAX, 1.05, 6.0,
                                        n_u_grid=N_U_COL).tables
        else:
            tb = je.BTRateControl(prob, P, T_MAX, 1.005, 6.0, "ecsq",
                                  n_s2_grid=N_S2, n_u_grid=N_U).tables
        out.append(jax.tree.map(np.asarray, tb))
    return out


@pytest.mark.parametrize("col", [False, True], ids=["row", "col"])
def test_stacked_bt_tables_decide_per_instance(col):
    """Stacked tables: each instance's decision is the bits of the call
    with its own tables alone, and the reference's within 1e-4."""
    j_tabs = _tables(col)
    conv = convert.col_bt_tables_from_arrays if col \
        else convert.bt_tables_from_arrays
    t_tabs = [conv(tb) for tb in j_tabs]
    stacked = te.stack_bt_tables(t_tabs)
    assert stacked.targets.shape == (3, T_MAX)
    j_fn, t_fn = ((je.col_bt_delta_for, te.col_bt_delta_for) if col
                  else (je.bt_delta_for, te.bt_delta_for))
    s2 = np.asarray([0.02, 0.3, 0.004], np.float32)
    for t in range(T_MAX):
        d_s, r_s = t_fn(stacked, t, torch.from_numpy(s2))
        assert d_s.shape == (3,) and r_s.shape == (3,)
        for i in range(3):
            d_i, r_i = t_fn(t_tabs[i], t, torch.tensor(s2[i]))
            assert torch.equal(d_s[i], d_i) and torch.equal(r_s[i], r_i), \
                (t, i, d_s[i], d_i, r_s[i], r_i)
            d_j, r_j = j_fn(j_tabs[i], t, jnp.float32(s2[i]))
            np.testing.assert_allclose(float(d_i), float(d_j), rtol=1e-4)
            np.testing.assert_allclose(float(r_i), float(r_j), rtol=1e-4,
                                       atol=1e-6)


def test_stacking_helpers():
    tb = convert.bt_tables_from_arrays(_tables(False)[0])
    padded = te.pad_bt_tables(tb, T_MAX + 3)
    assert padded.targets.shape == (T_MAX + 3,)
    assert torch.equal(padded.targets[:T_MAX], tb.targets)
    assert torch.all(padded.targets[T_MAX:] == tb.targets[-1])
    assert te.pad_bt_tables(tb, 3).targets.shape == (3,)
    d = te.BTTables.dummy(T_MAX, N_S2, N_U)
    for field, ref in zip(d, je.BTTables.dummy(T_MAX, N_S2, N_U)):
        np.testing.assert_array_equal(field.numpy(), np.asarray(ref))
    dc = te.ColBTTables.dummy(T_MAX, N_U_COL)
    for field, ref in zip(dc, je.ColBTTables.dummy(T_MAX, N_U_COL)):
        np.testing.assert_array_equal(field.numpy(), np.asarray(ref))
    both = te.stack_bt_tables([d, d])
    assert all(f.shape[0] == 2 for f in both)


@pytest.mark.parametrize("col", [False, True], ids=["row", "col"])
def test_masked_early_exit_is_exact(col):
    """An instance whose budget ends at t=3 inside a T_max=8 bucket carries
    exactly the bits of the same batch solved with T_max=3, and the plain
    solve of its own problem within float32 summation order."""
    specs = ([(512, 192, 0.1, 20.0, 3, "lossless"),
              (480, 160, 0.05, 20.0, 8, "lossless")] if not col else
             [(512, 128, 0.1, 20.0, 3, "lossless"),
              (480, 120, 0.05, 20.0, 8, "lossless")])
    a_b, y_b, probs, s0s = (_col_batch if col else _row_batch)(specs)
    _, hp = _params(specs, probs, col)
    t_layout = dict(layout=te.ColumnPartition(1)) if col else {}
    long_eng = te.AmpEngine(td.BernoulliGauss(), te.EngineConfig(
        n_proc=P, n_iter=T_MAX, device="cpu", **t_layout), te.EcsqTransport())
    short_eng = te.AmpEngine(td.BernoulliGauss(), te.EngineConfig(
        n_proc=P, n_iter=3, device="cpu", **t_layout), te.EcsqTransport())
    hp3 = hp._replace(sched=hp.sched[:, :3],
                      t_active=torch.full_like(hp.t_active, 3))
    long_tr = long_eng.solve_het(a_b, y_b, hp)
    short_tr = short_eng.solve_het(a_b, y_b, hp3)
    np.testing.assert_array_equal(long_tr.x[0], short_tr.x[0])
    np.testing.assert_array_equal(long_tr.sigma2_hat[0, :3],
                                  short_tr.sigma2_hat[0])
    assert np.all(long_tr.sigma2_hat[0, 3:] == 0.0)
    # the long instance kept going: a strictly better fit
    n_pad = P * a_b.shape[-1] if col else a_b.shape[-1]
    err = lambda x, i: np.mean((_unpad_x(x, specs[i][0], n_pad, col)
                                - s0s[i]) ** 2)
    assert err(long_tr.x[1], 1) < err(short_tr.x[1], 1)
    # and the short one is its own 3-iteration solve
    n, m = specs[0][:2]
    prob, _, a, y = _instance(0 if not col else 10, n, m, 0.1, 20.0)
    plain = te.AmpEngine(td.BernoulliGauss(0.1), te.EngineConfig(
        n_proc=P, n_iter=3, device="cpu", **t_layout),
        te.ExactFusion()).solve(y, a)
    np.testing.assert_allclose(_unpad_x(long_tr.x[0], n, n_pad, col),
                               plain.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(long_tr.sigma2_hat[0, :3], plain.sigma2_hat,
                               rtol=1e-5)


def test_drop_and_missing_bt_raise():
    """``HetParams.drop`` is taken now (erasure is ported): an all-zero
    (B, T, P) mask gives the drop-free bits, ``convert`` carries a
    reference mask across as a tensor, and a mask of the wrong shape — a
    missing T or P axis — raises."""
    a_b, y_b, probs, _ = _row_batch(ROW_SPECS[:2])
    j_hp, hp = _params(ROW_SPECS[:2], probs, col=False)
    _, teng = _engines(col=False)
    free = teng.solve_het(a_b, y_b, hp)
    zero = teng.solve_het(a_b, y_b, hp._replace(
        drop=torch.zeros(2, T_MAX, P)))
    for field in ("x", "sigma2_hat", "deltas", "extra_var", "rates"):
        np.testing.assert_array_equal(getattr(zero, field),
                                      getattr(free, field))
    mask = np.zeros((2, T_MAX, P), np.float32)
    mask[0, 1, 2] = 1.0
    conv = convert.het_params_from_arrays({**j_hp._asdict(), "drop": mask})
    assert conv.drop.dtype == torch.float32
    np.testing.assert_array_equal(conv.drop.numpy(), mask)
    with pytest.raises(ValueError, match="drop"):
        teng.solve_het(a_b, y_b, hp._replace(drop=torch.zeros(2, P)))


@pytest.mark.parametrize("update_z", [False, True])
def test_inner_step_per_instance_params_match_pallas(update_z):
    """K3's plain version with a (B, 4) ``par`` and (B, Np) masks, distinct
    per instance, against the reference's ``col_inner_pallas`` in interpret
    mode vmapped over B (as ``tests/test_kernels_col.py`` runs it). And
    under a batch of one, (4,) and (1, 4) give the same bits."""
    b, p, m, np_ = 3, 3, 64, 96
    rng = np.random.default_rng(5)
    a = (rng.normal(size=(b, p, m, np_)) / np.sqrt(m)).astype(np.float32)
    x = (0.1 * rng.normal(size=(b, p, np_))).astype(np.float32)
    x0 = (0.1 * rng.normal(size=(b, p, np_))).astype(np.float32)
    z = rng.normal(size=(b, p, m)).astype(np.float32)
    g = rng.normal(size=(b, m)).astype(np.float32)
    par = np.asarray([[64.0, 0.1, 0.0, 1.0], [48.0, 0.05, 0.2, 0.5],
                      [56.0, 0.2, -0.1, 2.0]], np.float32)
    mask = (np.arange(np_)[None, :] < np.asarray([96, 80, 50])[:, None]
            ).astype(np.float32)
    xt, ct, zt = tops.col_inner_step(
        *(torch.from_numpy(v) for v in (a, x, x0, z, g, mask, par)),
        update_z=update_z)
    assert xt.shape == (b, p, np_) and ct.shape == (b, p)

    def one(a_i, x_i, x0_i, z_i, g_i, mask_i, par_i):
        ap, gp = jops.pad_col_shards(a_i, g_i)
        zp = jnp.pad(z_i, ((0, 0), (0, ap.shape[1] - m)))
        xn, c, zn = jops.col_inner_step(
            ap, x_i, x0_i, zp, gp, mask_i, par_i[0], par_i[1], par_i[2],
            par_i[3], update_z=update_z, use_pallas=True, interpret=True)
        return xn, c, zn[:, :m]

    xk, ck, zk = jax.vmap(one)(*map(jnp.asarray, (a, x, x0, z, g, mask, par)))
    for got, want, what in ((xt, xk, "x'"), (ct, ck, "c_p"), (zt, zk, "z'")):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (what, err)
    assert np.all(xt.numpy()[1][:, 80:] == 0.0)
    # a batch of one: one shared row and one per-instance row, same bits
    one_b = [torch.from_numpy(v[:1]) for v in (a, x, x0, z, g)]
    r1 = col_inner_step_ref(*one_b, torch.from_numpy(mask[:1]),
                            torch.from_numpy(par[:1]), update_z)
    r2 = col_inner_step_ref(*one_b, torch.from_numpy(mask[0]),
                            col_params(*par[0]), update_z)
    for u, v in zip(r1, r2):
        assert torch.equal(u, v)
