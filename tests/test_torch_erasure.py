"""Erasure (the lossy link) in the port against the JAX package, on the CPU:
``ErasureSpec`` masks, the row survivor rescale and the column reset on
every transport, the heterogeneous batch with per-instance masks, the
fused block-quantize transport's erasure form, and the solve service's
erasure requests with their on-the-wire rates.

Inputs come from numpy (``test_torch_engine.make_problem``) and go to both
packages. Tolerances (the module docstring of ``test_torch_engine.py``):
a lossless solve under a mask is held to 1e-5 relative (float32 sums in
other orders, and the port keeps the drop-free noise account's order, see
below); a quantized one by ``assert_traces_agree``'s rule from the first
quantizer cell that the orders flip. The port's own drop-free solve and
its solve under an all-zero mask are held bit for bit: every erasure factor
is then an exact 1.0. (The reference's all-zero mask moves x by up to
1.2e-7: its ECSQ branch forms the noise account as (Delta^2/12) * n_surv *
scale^2 where its drop-free branch has P * Delta^2 / 12, and XLA fuses the
multiply by 1.0 otherwise; its ``test_engine_drop_zero_bit_exact`` is red
for that. The port multiplies the drop-free account by n_surv * scale^2 /
P, which is 1.0 exactly.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.core.engine as je
import repro.core.rate_alloc as jra
import repro.core.rate_distortion as jrd
import repro.core.state_evolution as jse
import repro.serving as jsv
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
import repro_torch.core.rate_alloc as tra
import repro_torch.core.rate_distortion as trd
import repro_torch.core.state_evolution as tse
import repro_torch.serving as tsv
from repro_torch import convert
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize.ref import block_quant_fuse_ref

from test_torch_engine import assert_traces_agree, make_problem

N, M, T, EPS = 1024, 384, 8, 0.1
P_ROW, P_COL = 6, 4
RATE = 0.2
FIELDS = ("x", "sigma2_hat", "deltas", "extra_var", "rates")


@pytest.fixture(scope="module")
def problem():
    return make_problem(21, N, M, EPS)


@pytest.fixture(scope="module")
def priors():
    return jd.BernoulliGauss(EPS), td.BernoulliGauss(EPS)


@pytest.fixture(scope="module")
def probs(priors):
    return jse.CSProblem(N, M, priors[0]), tse.CSProblem(N, M, priors[1])


@pytest.fixture(scope="module")
def mm(priors):
    return td.make_mmse_interp(priors[1], n_grid=100)


def _mask(model, p, seed=3, rate=RATE, t=T):
    return je.ErasureSpec(rate, model, 3.0, seed).sample_mask(t, p)


def _engines(priors, p, j_tp, t_tp, j_ctrl=None, t_ctrl=None, col=False):
    jl = dict(layout=je.ColumnPartition(1)) if col else {}
    tl = dict(layout=te.ColumnPartition(1)) if col else {}
    return (je.AmpEngine(priors[0], je.EngineConfig(n_proc=p, n_iter=T, **jl),
                         j_tp, j_ctrl),
            te.AmpEngine(priors[1], te.EngineConfig(n_proc=p, n_iter=T,
                                                    device="cpu", **tl),
                         t_tp, t_ctrl))


# ---------------------------------------------------------------------------
# ErasureSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["bernoulli", "gilbert"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.35])
@pytest.mark.parametrize("shape", [(6, 4), (10, 30), (1, 1)])
@pytest.mark.parametrize("seed", [0, 1234])
def test_sample_mask_bit_identical(model, rate, shape, seed):
    """The same numpy generator in the same draw order: the same bits, and
    a ``seed=`` override draws as the reference's does."""
    j = je.ErasureSpec(rate, model, 4.0, seed)
    t = te.ErasureSpec(rate, model, 4.0, seed)
    got, want = t.sample_mask(*shape), j.sample_mask(*shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.sample_mask(*shape, seed=seed + 5),
                                  j.sample_mask(*shape, seed=seed + 5))


@pytest.mark.parametrize("kw", [{"rate": 1.0}, {"rate": -0.1},
                                {"model": "burst"}, {"burst_len": 0.5}])
def test_erasure_spec_rejects_bad_fields(kw):
    with pytest.raises(ValueError):
        te.ErasureSpec(**{"rate": 0.1, **kw})


# ---------------------------------------------------------------------------
# single solves under a mask, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["bernoulli", "gilbert"])
@pytest.mark.parametrize("fusion", ["exact", "ecsq_lossless"])
def test_row_lossless_under_mask_matches_reference(model, fusion, problem,
                                                   priors):
    s0, a, y = problem
    inf = [np.inf] * T
    tps = ((je.ExactFusion(), te.ExactFusion()) if fusion == "exact"
           else (je.EcsqTransport(), te.EcsqTransport()))
    jeng, teng = _engines(priors, P_ROW, *tps, je.FixedSchedule(inf),
                          te.FixedSchedule(inf))
    drop = _mask(model, P_ROW)
    assert 0 < drop.sum() < drop.size
    want, got = jeng.solve(y, a, drop_sched=drop), teng.solve(y, a,
                                                              drop_sched=drop)
    np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat, rtol=1e-5)
    np.testing.assert_allclose(got.x, want.x, rtol=0,
                               atol=1e-5 * np.abs(want.x).max())
    np.testing.assert_array_equal(got.extra_var, 0.0)


def _row_controllers(kind, probs, priors, mm):
    """Both packages' controller (or transport) of a quantized row solve,
    planned for the lossy link where the controller plans (DP, BT)."""
    er = dict(erasure_rate=RATE, recovery="retransmit")
    if kind == "fixed":
        d = [np.inf] + [0.03] * (T - 1)
        return (je.EcsqTransport(), te.EcsqTransport(), je.FixedSchedule(d),
                te.FixedSchedule(d))
    if kind == "dp":
        jr, tr = jrd.RDModel(priors[0]), trd.RDModel(priors[1])
        jdp = jra.dp_allocate(probs[0], P_ROW, T, 2.0 * T, rd=jr,
                              mmse_fn=mm, **er)
        tdp = tra.dp_allocate(probs[1], P_ROW, T, 2.0 * T, rd=tr,
                              mmse_fn=mm, **er)
        js, ts = je.DPSchedule(jdp, jr, P_ROW), te.DPSchedule(tdp, tr, P_ROW)
        np.testing.assert_array_equal(ts.deltas, js.deltas)
        return je.EcsqTransport(), te.EcsqTransport(), js, ts
    if kind == "bt":
        jbt = je.BTRateControl(probs[0], P_ROW, T, 1.02, mmse_fn=mm,
                               n_s2_grid=8, n_u_grid=15, **er)
        tbt = te.BTRateControl(probs[1], P_ROW, T, 1.02, mmse_fn=mm,
                               n_s2_grid=8, n_u_grid=15, **er)
        return je.EcsqTransport(), te.EcsqTransport(), jbt, tbt
    return (je.BlockQuantTransport(8, 256), te.BlockQuantTransport(8, 256),
            None, None)


@pytest.mark.parametrize("model", ["bernoulli", "gilbert"])
@pytest.mark.parametrize("kind", ["fixed", "dp", "bt", "block8"])
def test_quantized_row_under_mask_follows_the_trace_rule(kind, model,
                                                         problem, probs,
                                                         priors, mm):
    s0, a, y = problem
    j_tp, t_tp, j_c, t_c = _row_controllers(kind, probs, priors, mm)
    jeng, teng = _engines(priors, P_ROW, j_tp, t_tp, j_c, t_c)
    drop = _mask(model, P_ROW)
    want, got = jeng.solve(y, a, drop_sched=drop), teng.solve(y, a,
                                                              drop_sched=drop)
    assert np.all(np.isfinite(got.x))
    fin = np.isfinite(np.asarray(want.extra_var))
    np.testing.assert_allclose(got.extra_var[fin],
                               np.asarray(want.extra_var)[fin], rtol=1e-3)
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("model", ["bernoulli", "gilbert"])
@pytest.mark.parametrize("kind", ["exact", "fixed", "block8"])
def test_column_reset_matches_reference(kind, model, problem, priors):
    """The column layout's erasure is a reset: the erased blocks of x are
    zeroed before the residual, the boundary coefficient and the noise
    account scale by the survivors' share, the transport runs drop-free."""
    s0, a, y = problem
    if kind == "exact":
        tps = (je.ExactFusion(), te.ExactFusion(), None, None)
    elif kind == "fixed":
        d = [np.inf] + [0.01] * (T - 1)
        tps = (je.EcsqTransport(), te.EcsqTransport(), je.FixedSchedule(d),
               te.FixedSchedule(d))
    else:
        tps = (je.BlockQuantTransport(8, 128), te.BlockQuantTransport(8, 128),
               None, None)
    jeng, teng = _engines(priors, P_COL, *tps, col=True)
    drop = _mask(model, P_COL)
    want, got = jeng.solve(y, a, drop_sched=drop), teng.solve(y, a,
                                                              drop_sched=drop)
    if kind == "exact":
        np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat, rtol=1e-5)
        np.testing.assert_allclose(got.x, want.x, rtol=0,
                                   atol=1e-5 * np.abs(want.x).max())
        return
    np.testing.assert_allclose(got.extra_var, np.asarray(want.extra_var),
                               rtol=1e-5, atol=1e-12)
    assert_traces_agree(want, got, s0)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("kind", ["exact", "fixed", "block8", "bt"])
def test_all_zero_mask_gives_the_drop_free_bits(layout, kind, problem,
                                                probs, priors, mm):
    """The intent of the reference's red ``test_engine_drop_zero_bit_exact``
    held on the port: a mask that loses nothing runs the erasure code and
    gives the drop-free solve's bits in every field."""
    s0, a, y = problem
    col = layout == "col"
    p = P_COL if col else P_ROW
    if kind == "exact":
        tp, ctrl = te.ExactFusion(), None
    elif kind == "fixed":
        tp, ctrl = te.EcsqTransport(), te.FixedSchedule(
            [np.inf] + [0.02] * (T - 1))
    elif kind == "block8":
        tp, ctrl = te.BlockQuantTransport(8, 256), None
    else:
        tp = te.EcsqTransport()
        ctrl = (te.ColumnBTRateControl(probs[1], p, T, mmse_fn=mm,
                                       n_u_grid=32) if col
                else te.BTRateControl(probs[1], p, T, mmse_fn=mm,
                                      n_s2_grid=8, n_u_grid=15))
    tl = dict(layout=te.ColumnPartition(1)) if col else {}
    eng = te.AmpEngine(priors[1], te.EngineConfig(n_proc=p, n_iter=T,
                                                  device="cpu", **tl),
                       tp, ctrl)
    free = eng.solve(y, a)
    zero = eng.solve(y, a, drop_sched=np.zeros((T, p), np.float32))
    for field in FIELDS + ("symbols",):
        np.testing.assert_array_equal(getattr(zero, field),
                                      getattr(free, field), err_msg=field)


def test_erasure_costs_fidelity_but_stays_bounded(problem, priors):
    """The reference's own bound on a lossy link, on the port: MSE finite,
    above the clean solve's, under 50x it."""
    s0, a, y = problem
    inf = [np.inf] * T
    eng = te.AmpEngine(priors[1], te.EngineConfig(n_proc=P_ROW, n_iter=T,
                                                  device="cpu"),
                       te.ExactFusion(), te.FixedSchedule(inf))
    clean = float(eng.solve(y, a).mse(s0)[-1])
    lossy = float(eng.solve(y, a, drop_sched=_mask("bernoulli", P_ROW,
                                                   seed=1, rate=0.25))
                  .mse(s0)[-1])
    assert np.isfinite(lossy) and clean < lossy < 50 * clean


def test_bad_drop_shape_raises(problem, priors):
    s0, a, y = problem
    eng = te.AmpEngine(priors[1], te.EngineConfig(n_proc=P_ROW, n_iter=T,
                                                  device="cpu"))
    with pytest.raises(ValueError, match="drop_sched"):
        eng.solve(y, a, drop_sched=np.zeros((T, P_ROW + 1), np.float32))


# ---------------------------------------------------------------------------
# the fused block-quantize transport's erasure form
# ---------------------------------------------------------------------------

def _keep_rows(p):
    one = np.zeros(p, np.float32)
    one[1] = 1.0
    rng = np.random.default_rng(4)
    return {"random": (rng.random(p) > 0.3).astype(np.float32),
            "one_survivor": one, "none": np.zeros(p, np.float32),
            "all": np.ones(p, np.float32)}


@pytest.mark.parametrize("mask", ["random", "one_survivor", "none", "all"])
@pytest.mark.parametrize("shape", [(5, 1000, 256), (3, 700, 512)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_k4_plain_erasure_form_matches_reference(mask, shape, qmax):
    """``block_quant_fuse_ref(keep=)`` against the reference's
    ``BlockQuantTransport.fuse(drop=)``: symbols equal, f and extra within
    1e-6 (float32 sums in p order against XLA's; ``test_torch_block_quant_
    fuse.py``); every flag 1 gives the drop-free plain version's bits."""
    p, length, block = shape
    rng = np.random.default_rng(9)
    x = rng.normal(size=(p, length)).astype(np.float32)
    x[0] *= 1e3
    keep = _keep_rows(p)[mask]
    jt = je.BlockQuantTransport({127: 8, 7: 4}[qmax], block)
    jf, jextra, jsym = jt.fuse(jnp.asarray(x), jnp.float32(np.inf),
                               jnp.asarray(1.0 - keep))
    f, extra, sym = block_quant_fuse_ref(torch.from_numpy(x)[None], qmax,
                                         block, keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(sym[0].numpy(), np.asarray(jsym))
    jf = np.asarray(jf)
    np.testing.assert_allclose(f[0].numpy(), jf, rtol=0,
                               atol=1e-6 * max(np.abs(jf).max(), 1e-30))
    np.testing.assert_allclose(float(extra[0]), float(jextra), rtol=1e-6)
    if mask == "all":
        free = block_quant_fuse_ref(torch.from_numpy(x)[None], qmax, block)
        for g_, w in zip((f, extra, sym), free):
            assert torch.equal(g_, w)


def test_k4_erasure_form_per_instance_rows_and_dispatch():
    """(B, P) keep rows: each batch entry is the same bits as alone with its
    row; a shared (P,) row is the same as that row repeated; ``ops``
    takes the plain version for CPU tensors."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 5, 600)).astype(np.float32))
    keep = torch.from_numpy((rng.random((3, 5)) > 0.4).astype(np.float32))
    f, extra, sym = tqops.block_quant_fuse(x, 127, 256, keep=keep)
    for i in range(3):
        fi, ei, si = block_quant_fuse_ref(x[i:i + 1], 127, 256, keep=keep[i])
        assert torch.equal(f[i], fi[0]) and torch.equal(extra[i], ei[0])
        assert torch.equal(sym[i], si[0])
    shared = block_quant_fuse_ref(x, 127, 256, keep=keep[0])
    repeated = block_quant_fuse_ref(x, 127, 256, keep=keep[0].expand(3, 5))
    for g_, w in zip(shared, repeated):
        assert torch.equal(g_, w)


# ---------------------------------------------------------------------------
# heterogeneous batches with per-instance masks
# ---------------------------------------------------------------------------

def _het_case(col):
    """Three instances of their own size and prior, lossless schedules;
    instance 1 loses no packet (an all-zero row of the mask)."""
    p = P_COL if col else P_ROW
    specs = [(480, 192, 0.10), (512, 192, 0.05), (448, 168, 0.10)]
    n_pad, m_pad = 512, 192
    b = len(specs)
    if col:
        a_b = np.zeros((b, p, m_pad, n_pad // p), np.float32)
        y_b = np.zeros((b, m_pad), np.float32)
    else:
        a_b = np.zeros((b, p, m_pad // p, n_pad), np.float32)
        y_b = np.zeros((b, p, m_pad // p), np.float32)
    drop = np.zeros((b, T, p), np.float32)
    for i, (n, m, eps) in enumerate(specs):
        s0, a, y = make_problem(40 + i, n, m, eps)
        if col:
            a_b[i, :, :m, :n // p] = je.split_problem_cols(a, p)
            y_b[i, :m] = y
        else:
            a_b[i, :, :m // p, :n] = a.reshape(p, m // p, n)
            y_b[i, :, :m // p] = y.reshape(p, m // p)
        if i != 1:
            drop[i] = _mask("gilbert" if i else "bernoulli", p, seed=i)
    tables = [je.ColBTTables.dummy(T, n_u=16) if col
              else je.BTTables.dummy(T, 6, 11) for _ in specs]
    hp = je.HetParams(
        sched=np.full((b, T), np.inf, np.float32),
        t_active=np.full(b, T, np.int32),
        m_real=np.asarray([m for _, m, _ in specs], np.float32),
        n_real=np.asarray([n for n, _, _ in specs], np.int32),
        eps=np.asarray([e for *_, e in specs], np.float32),
        mu_s=np.zeros(b, np.float32), sigma_s=np.ones(b, np.float32),
        use_bt=np.zeros(b, bool), bt=je.stack_bt_tables(tables), drop=drop)
    return a_b, y_b, jax.tree.map(np.asarray, hp), p


@pytest.mark.parametrize("layout", ["row", "col"])
def test_het_batch_with_masks_matches_reference(layout):
    col = layout == "col"
    a_b, y_b, j_hp, p = _het_case(col)
    t_hp = convert.het_params_from_arrays(j_hp)
    assert t_hp.drop.shape == (3, T, p)
    jl = dict(layout=je.ColumnPartition(1)) if col else {}
    tl = dict(layout=te.ColumnPartition(1)) if col else {}
    jeng = je.AmpEngine(jd.BernoulliGauss(), je.EngineConfig(
        n_proc=p, n_iter=T, **jl), je.EcsqTransport())
    teng = te.AmpEngine(td.BernoulliGauss(), te.EngineConfig(
        n_proc=p, n_iter=T, device="cpu", **tl), te.EcsqTransport())
    want = jeng.solve_het(a_b, y_b, j_hp)
    got = teng.solve_het(a_b, y_b, t_hp, has_bt=False)
    np.testing.assert_allclose(got.sigma2_hat, np.asarray(want.sigma2_hat),
                               rtol=1e-5)
    wx = np.asarray(want.x)
    np.testing.assert_allclose(got.x, wx, rtol=0,
                               atol=1e-5 * np.abs(wx).max())
    # the lossless instance of the erasure batch: the drop-free bits
    free = teng.solve_het(a_b, y_b, t_hp._replace(drop=None), has_bt=False)
    np.testing.assert_array_equal(got.x[1], free.x[1])
    np.testing.assert_array_equal(got.sigma2_hat[1], free.sigma2_hat[1])
    # the mask rides as an operand: one program with and without it
    assert teng.counters() == {"compiles": 1, "dispatches": 2}


# ---------------------------------------------------------------------------
# the service: erasure requests and their on-the-wire rates
# ---------------------------------------------------------------------------

POL = tsv.BucketPolicy(max_batch=4, n_quantum=64, mp_quantum=8)


def _requests(pkg, problem_seeds):
    out = []
    for i, (policy, rate, model, recovery) in enumerate(problem_seeds):
        s0, a, y = make_problem(60 + i, 256, 96, 0.1)
        deltas = None
        if policy == "fixed":
            deltas = np.full(6, 0.05, np.float32)
            deltas[0] = np.inf
        prior = (jd if pkg is jsv else td).BernoulliGauss(0.1)
        out.append(pkg.SolveRequest(
            y=y, a=a, prior=prior, n_proc=4, n_iter=6, policy=policy,
            deltas=deltas, erasure_rate=rate, erasure_model=model,
            erasure_burst=3.0, erasure_seed=7 + i, recovery=recovery,
            layout="row"))
    return out


SERVE_MIX = [("lossless", 0.0, "bernoulli", "retransmit"),
             ("fixed", 0.2, "bernoulli", "retransmit"),
             ("fixed", 0.2, "gilbert", "rate_up"),
             ("lossless", 0.2, "gilbert", "retransmit")]


@pytest.fixture(scope="module")
def served():
    jsvc = jsv.SolveService(policy=POL)
    tsvc = tsv.SolveService(policy=POL, device="cpu")
    want = jsvc.solve(_requests(jsv, SERVE_MIX))
    got = tsvc.solve(_requests(tsv, SERVE_MIX))
    return want, got, tsvc


@pytest.mark.parametrize("i", range(len(SERVE_MIX)),
                         ids=[f"{p}-{r}-{m}-{c}" for p, r, m, c in SERVE_MIX])
def test_service_erasure_requests_match_reference(served, i):
    """One batch of four (erasure and lossless requests mixed) on each
    side: the estimates by the trace rule, and the rates — on-the-wire
    under erasure, the delivered model rate times the recovery policy's
    wire factor — within 1e-4."""
    want, got, _ = served
    w, g = want[i], got[i]
    assert g.batch_size == 4 and g.bucket.layout == "row"
    np.testing.assert_array_equal(g.deltas, np.asarray(w.deltas))
    np.testing.assert_allclose(g.sigma2_hat, np.asarray(w.sigma2_hat),
                               rtol=1e-3)
    np.testing.assert_array_equal(np.isinf(g.rates), np.isinf(w.rates))
    fin = np.isfinite(w.rates)
    np.testing.assert_allclose(g.rates[fin], np.asarray(w.rates)[fin],
                               rtol=1e-4)
    assert g.total_bits == pytest.approx(w.total_bits, rel=1e-4)


def test_service_rates_scale_by_the_wire_factor(served):
    """The same request on a lossless link and on a lossy one: the lossy
    rates are the delivered ones times 1 / (1 - rate) under retransmit."""
    _, got, tsvc = served
    lossy = got[1]
    req = _requests(tsv, SERVE_MIX[1:2])[0]
    delivered = tsvc._rates_delivered(req, lossy.sigma2_hat, lossy.deltas,
                                      lossy.rates, lossy.extra_var)
    fin = np.isfinite(delivered)
    np.testing.assert_allclose(lossy.rates[fin], delivered[fin] / 0.8,
                               rtol=1e-12)


def test_service_erasure_mask_is_the_request_s_own(served):
    """A request's served result equals its single solve with the mask
    ``ErasureSpec`` draws from its erasure fields (lossless: 1e-5)."""
    _, got, tsvc = served
    req = _requests(tsv, SERVE_MIX)[3]
    mask = tsvc._drop_mask(req)
    np.testing.assert_array_equal(mask, te.ErasureSpec(
        0.2, "gilbert", 3.0, req.erasure_seed).sample_mask(6, 4))
    eng = te.AmpEngine(req.prior, te.EngineConfig(n_proc=4, n_iter=6,
                                                  device="cpu"),
                       te.EcsqTransport())
    one = eng.solve(req.y, req.a, drop_sched=mask)
    np.testing.assert_allclose(got[3].sigma2_hat, one.sigma2_hat, rtol=1e-5)
    np.testing.assert_allclose(got[3].x, one.x, rtol=0,
                               atol=1e-5 * np.abs(one.x).max())


def test_service_measured_wire_counts_retransmits():
    """``measure_wire`` on an erasure request: a dropped packet is counted
    twice under retransmit, once under rate_up."""
    s0, a, y = make_problem(77, 256, 96, 0.1)
    d = np.full(6, 0.05, np.float32)
    svc = tsv.SolveService(policy=POL, device="cpu")
    base = dict(y=y, a=a, prior=td.BernoulliGauss(0.1), n_proc=4, n_iter=6,
                policy="fixed", deltas=d, erasure_rate=0.3, erasure_seed=5,
                measure_wire=True, layout="row")
    rt, ru = svc.solve([tsv.SolveRequest(**base, recovery="retransmit"),
                        tsv.SolveRequest(**base, recovery="rate_up")])
    assert rt.payload_bytes == ru.payload_bytes > 0
    assert rt.bytes_on_wire > ru.bytes_on_wire
