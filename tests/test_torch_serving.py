"""The port's solve service (``repro_torch.serving``) on the CPU: bucketing,
continuous batching, the operand cache, and the heterogeneous batch held
against the port's own single solves — the twins of the JAX package's
``tests/test_serving.py`` and ``tests/test_serving_hotpath.py`` — and its
rate accounting against the reference service's.

Inputs are drawn with numpy from seeds. Tolerances: a batched request and
its own single solve are the same arithmetic on differently shaped stacks
(float32 sums in other orders), held to rtol 1e-4 on ``sigma2_hat`` and the
bins and 1e-5 on the MSE between their estimates. A BT request is held by
``assert_traces_agree``'s rule (``test_torch_engine.py``), read off the
traces the service returns: tight (rtol 1e-4) up to the first iteration
where the two runs' plug-ins part (a bin one cell off moves them
together), ``sigma2_hat`` within 10 % and the final MSE within 1 dB after.
That is the intent of the reference's ``test_heterogeneous_batch_matches_
single``, whose BT request parts from its single solve in the sixth digit
(ROADMAP.md Queue 3). Rates against the reference service: rtol 1e-4.
"""
import dataclasses
import threading
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.denoisers as jd
import repro.serving as jserving
import repro_torch.core.engine as te
import repro_torch.launch.amp_serve as tamp_serve
from repro_torch.core.denoisers import BernoulliGauss
from repro_torch.core.rate_alloc import dp_allocate
from repro_torch.core.rate_distortion import RDModel
from repro_torch.core.state_evolution import CSProblem
from repro_torch.serving import (Batcher, BucketPolicy, OperandCache,
                                 PrewarmSpec, SolveRequest, SolveService,
                                 batch_width_ladder, bucket_for, fingerprint,
                                 pad_batch_size, placement_for)


def sample(seed, n, m, prior, snr_db=20.0):
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr_db)
    rng = np.random.default_rng(seed)
    s0 = ((rng.random(n) < prior.eps) * rng.normal(size=n)).astype(np.float32)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)
         ).astype(np.float32)
    return prob, s0, a, y


def single(req, transport=None, controller=None, **cfg):
    """The port's own single solve of a request (row layout)."""
    eng = te.AmpEngine(req.prior, te.EngineConfig(
        n_proc=req.n_proc, n_iter=req.n_iter, collect_symbols=False,
        collect_xs=True, device="cpu", **cfg),
        transport or te.EcsqTransport(), controller)
    return eng.solve(req.y, req.a)


def assert_result_agrees(want, res, s0):
    """``assert_traces_agree``'s rule on a service result (module
    docstring): tight until the plug-ins part, statistical after."""
    s2_w, s2_g = np.asarray(want.sigma2_hat), res.sigma2_hat
    close = np.isclose(s2_g, s2_w, rtol=1e-4) & \
        np.isclose(res.deltas, want.deltas, rtol=1e-4)
    first = int(np.argmin(close)) if not close.all() else len(close)
    assert first >= 1, "the first plug-in precedes any quantization"
    np.testing.assert_allclose(res.rates[:first], want.rates[:first],
                               rtol=1e-4)
    np.testing.assert_allclose(s2_g, s2_w, rtol=0.10)
    mse_w = float(np.mean((want.x - s0) ** 2))
    assert abs(10 * np.log10(res.mse(s0) / mse_w)) < 1.0
    if first == len(close):
        np.testing.assert_allclose(res.x, want.x, atol=1e-4)


# ---------------------------------------------------------------------------
# bucketing / batching units (pure Python: the reference's own cases)
# ---------------------------------------------------------------------------

def test_bucket_rounding_and_placement():
    pol = BucketPolicy(n_quantum=256, mp_quantum=16, t_quantum=4)
    k = bucket_for(600, 180, 5, 6, "ecsq", pol)
    assert (k.n_pad, k.mp_pad, k.n_proc, k.t_max, k.m_pad) == \
        (768, 48, 5, 8, 240)
    assert bucket_for(512, 160, 5, 8, "block8", pol) != \
        bucket_for(512, 160, 5, 8, "ecsq", pol)
    with pytest.raises(AssertionError):
        bucket_for(512, 161, 5, 8, "ecsq", pol)
    assert [pad_batch_size(b, BucketPolicy(max_batch=128))
            for b in (1, 2, 3, 8, 9, 128)] == [1, 2, 4, 8, 16, 128]
    pol = BucketPolicy(shard_elems=1 << 20)
    assert placement_for(512, 160, 4, 1, pol) == ("local", "row")
    assert placement_for(4096, 512, 8, 1, pol) == ("local", "col")
    assert placement_for(4098, 512, 8, 1, pol)[1] == "row"
    k_c = bucket_for(4096, 500, 8, 8, "ecsq", pol, "local", "col")
    assert (k_c.m_pad, k_c.n_pad) == (512, 4096)
    assert batch_width_ladder(BucketPolicy(max_batch=8)) == (1, 2, 4, 8)
    # the paper's point and its neighbour share one row bucket under the
    # quanta chip_smoke.py serves them with
    pol8 = BucketPolicy(max_batch=8, n_quantum=2048, mp_quantum=112,
                        t_quantum=6)
    k1 = bucket_for(10000, 3000, 30, 10, "ecsq", pol8)
    k2 = bucket_for(9000, 2700, 30, 8, "ecsq", pol8)
    assert k1 == k2 and (k1.n_pad, k1.mp_pad, k1.t_max) == (10240, 112, 12)


def test_batcher_dispatch_drain_and_demand_windows():
    pol = BucketPolicy(max_batch=4)
    b = Batcher(pol)
    k1 = bucket_for(512, 160, 5, 8, "ecsq", pol)
    k2 = bucket_for(256, 80, 5, 8, "ecsq", pol)
    for i in range(3):
        assert b.add(k1, f"a{i}") is None
    assert b.add(k2, "b0") is None
    key, group = b.add(k1, "a3")
    assert key == k1 and group == ["a0", "a1", "a2", "a3"]
    assert list(b.drain()) == [(k2, ["b0"])] and len(b) == 0
    # demand windows partition the admission stream
    assert b.take_demand() == {k1: 4, k2: 1}
    assert b.take_demand() == {}
    b.add(k2, "b1")
    assert b.take_demand() == {k2: 1}
    assert b.demand() == {k1: 4, k2: 2}
    b.add(k1, "a4")
    b.clear_demand()
    assert b.take_demand() == {} and b.demand()[k1] == 5
    b.clear_demand(lifetime=True)
    assert b.demand() == {}


def test_batcher_demand_concurrent_admission():
    pol = BucketPolicy(max_batch=1 << 20)
    b = Batcher(pol)
    k = bucket_for(512, 160, 5, 8, "ecsq", pol)
    takes = []

    def admit():
        for i in range(2000):
            b.add(k, i)

    threads = [threading.Thread(target=admit) for _ in range(6)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        takes.append(b.take_demand().get(k, 0))
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    takes.append(b.take_demand().get(k, 0))
    assert sum(takes) == 6 * 2000 == b.demand()[k]


def test_operand_cache_lru_by_bytes():
    cache = OperandCache(max_bytes=3 * 4096)
    mk = lambda v: (lambda: torch.full((1024,), float(v)))    # 4096 bytes
    for i in range(3):
        cache.get(("k", i), mk(i))
    assert cache.nbytes == 3 * 4096 and len(cache) == 3
    assert float(cache.get(("k", 0), mk(99))[0]) == 0.0       # hit, now MRU
    cache.get(("k", 3), mk(3))                                # evicts k1
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (1, 4, 1)
    assert ("k", 1) not in cache._entries and ("k", 0) in cache._entries
    # one entry over the budget still serves its own stream
    big = cache.get(("big",), lambda: torch.zeros(8192))
    assert len(cache) == 1 and big.numel() == 8192
    # tuples of tensors count every tensor's bytes
    cache.clear(reset_stats=True)
    cache.get(("pair",), lambda: (torch.zeros(10), torch.zeros(5,
                                                               dtype=torch.bfloat16)))
    assert cache.nbytes == 50 and cache.stats()["hits"] == 0
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    f0 = fingerprint(a)
    a[0, 0] = 5.0
    assert fingerprint(a) != f0 and fingerprint(a.T) != fingerprint(a)


# ---------------------------------------------------------------------------
# heterogeneous batch == single solves
# ---------------------------------------------------------------------------

# (eps, snr_db, n, m, p, t, policy)
SPECS = [(0.10, 20.0, 600, 180, 5, 6, "fixed"),
         (0.05, 20.0, 768, 240, 5, 8, "lossless"),
         (0.10, 15.0, 500, 150, 5, 5, "bt"),
         (0.10, 20.0, 600, 180, 5, 6, "dp"),
         (0.05, 20.0, 512, 160, 4, 8, "fixed")]


@pytest.fixture(scope="module")
def mixed_ctx():
    reqs, refs, s0s = [], [], []
    for i, (eps, snr, n, m, p, t, policy) in enumerate(SPECS):
        prior = BernoulliGauss(eps=eps)
        prob, s0, a, y = sample(i, n, m, prior, snr)
        kw, ctrl = {}, None
        if policy == "fixed":
            deltas = np.full(t, 0.05, np.float32)
            deltas[0] = np.inf
            kw["deltas"] = deltas
            ctrl = te.FixedSchedule(deltas)
        elif policy == "dp":
            # the RD table for this prior ships in .cache (committed)
            rd = RDModel(prior)
            ctrl = te.DPSchedule(dp_allocate(prob, p, t, 2.0 * t, rd=rd),
                                 rd, p)
            kw["deltas"] = ctrl.deltas
        elif policy == "bt":   # the service builds identical tables
            ctrl = te.BTRateControl(prob, p, t, 1.005, 6.0, "ecsq")
        reqs.append(SolveRequest(y=y, a=a, prior=prior, snr_db=snr,
                                 n_proc=p, n_iter=t, policy=policy, **kw))
        refs.append(single(reqs[-1], controller=ctrl))
        s0s.append(s0)
    svc = SolveService(policy=BucketPolicy(max_batch=8), device="cpu")
    return reqs, refs, s0s, svc.solve(reqs), svc


@pytest.mark.parametrize("i", range(len(SPECS)),
                         ids=[s[-1] + str(i) for i, s in enumerate(SPECS)])
def test_heterogeneous_batch_matches_single(mixed_ctx, i):
    reqs, refs, s0s, results, _ = mixed_ctx
    res, ref = results[i], refs[i]
    assert res.request_id == i
    assert res.x.shape == (reqs[i].n,) and res.sigma2_hat.shape == \
        (reqs[i].n_iter,)
    if reqs[i].policy == "bt":
        assert_result_agrees(ref, res, s0s[i])
        return
    assert float(np.mean((res.x - ref.x) ** 2)) <= 1e-5
    np.testing.assert_allclose(res.sigma2_hat, ref.sigma2_hat, rtol=1e-4)
    np.testing.assert_allclose(res.deltas, ref.deltas, rtol=1e-4)


def test_bt_rate_accounting_matches_controller(mixed_ctx):
    reqs, refs, _, results, _ = mixed_ctx
    i_bt = [r.policy for r in reqs].index("bt")
    np.testing.assert_allclose(results[i_bt].rates, refs[i_bt].rates,
                               atol=5e-3)
    assert np.isfinite(results[i_bt].total_bits) and results[i_bt].tracked
    i_ll = [r.policy for r in reqs].index("lossless")
    assert results[i_ll].total_bits == 0.0
    assert np.isinf(results[i_ll].rates).all() and not results[i_ll].tracked


def test_rate_accounting_matches_reference_service(mixed_ctx):
    """Lossless, fixed, DP and block8 requests: the port's service reports
    the reference service's per-iteration rates."""
    reqs, _, _, results, _ = mixed_ctx
    keep = [i for i, r in enumerate(reqs) if r.policy != "bt"]
    prior, s0, a, y = (None,) + sample(9, 600, 180, BernoulliGauss(0.1))[1:]
    b8 = SolveRequest(y=y, a=a, prior=BernoulliGauss(0.1), n_proc=5,
                      n_iter=6, transport="block8")
    got = [results[i] for i in keep] + SolveService(
        policy=BucketPolicy(max_batch=4), device="cpu").solve([b8])
    to_ref = lambda r: jserving.SolveRequest(
        **{f.name: getattr(r, f.name) for f in dataclasses.fields(r)
           if f.name not in ("prior", "request_id", "spans")},
        prior=jd.BernoulliGauss(r.prior.eps, r.prior.mu_s, r.prior.sigma_s))
    want = jserving.SolveService(policy=jserving.BucketPolicy(max_batch=8)
                                 ).solve([to_ref(reqs[i]) for i in keep]
                                         + [to_ref(b8)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isinf(g.rates), np.isinf(w.rates))
        fin = np.isfinite(w.rates)
        np.testing.assert_allclose(g.rates[fin], w.rates[fin], rtol=1e-4)
        np.testing.assert_allclose(g.total_bits, w.total_bits, rtol=1e-4)
    np.testing.assert_allclose(got[-1].rates, 8.0 + 16.0 / 512)


def test_masked_early_exit_is_exact():
    """A short-T request inside a long-T bucket returns its own T-iteration
    solve (the batch freezes it, it does not truncate it). 512/128 sits at
    the aspect threshold: a column bucket, held against the row solve
    (both are centralized AMP under lossless fusion)."""
    prior = BernoulliGauss(eps=0.1)
    _, s0, a, y = sample(9, 512, 128, prior)
    svc = SolveService(policy=BucketPolicy(max_batch=4, t_quantum=8),
                       device="cpu")
    short = SolveRequest(y=y, a=a, prior=prior, n_proc=4, n_iter=3)
    long_ = SolveRequest(y=y, a=a, prior=prior, n_proc=4, n_iter=8)
    res_short, res_long = svc.solve([short, long_])
    assert res_short.bucket == res_long.bucket
    assert res_short.bucket.layout == "col" and res_short.bucket.t_max == 8
    ref3 = single(short, te.ExactFusion())
    assert float(np.mean((res_short.x - ref3.x) ** 2)) <= 1e-10
    assert res_short.sigma2_hat.shape == (3,)
    assert res_long.mse(s0) < res_short.mse(s0)


def test_block_transport_bucket_matches_single():
    prior = BernoulliGauss(eps=0.1)
    _, s0, a, y = sample(3, 600, 180, prior)
    svc = SolveService(policy=BucketPolicy(max_batch=4), device="cpu")
    req = SolveRequest(y=y, a=a, prior=prior, n_proc=5, n_iter=6,
                       transport="block8")
    # two requests: the batched (het) path, not the singleton one
    res, res2 = svc.solve([req, dataclasses.replace(req)])
    ref = single(req, te.BlockQuantTransport(bits=8, block=512))
    assert float(np.mean((res.x - ref.x) ** 2)) <= 1e-5
    np.testing.assert_allclose(res.sigma2_hat, ref.sigma2_hat, rtol=1e-4)
    np.testing.assert_allclose(res.rates, 8.0 + 16.0 / 512)
    assert res.bucket.transport == "block8" and res.batch_size == 2
    with pytest.raises(ValueError, match="no effect under"):
        svc.solve([SolveRequest(y=y, a=a, prior=prior, n_proc=5, n_iter=6,
                                policy="bt", transport="block8")])


def test_resubmitting_same_request_object():
    prior = BernoulliGauss(eps=0.1)
    _, _, a, y = sample(4, 256, 64, prior)
    svc = SolveService(policy=BucketPolicy(max_batch=4),
                       rate_accounting=False, device="cpu")
    req = SolveRequest(y=y, a=a, prior=prior, n_proc=4, n_iter=4)
    r1, r2 = svc.solve([req, req])
    assert r1.request_id != r2.request_id
    np.testing.assert_allclose(r1.x, r2.x)


def test_stream_continuous_batching():
    prior = BernoulliGauss(eps=0.1)
    insts = [sample(i, 256, 64, prior) for i in range(5)]
    svc = SolveService(policy=BucketPolicy(max_batch=2),
                       rate_accounting=False, device="cpu")
    reqs = [SolveRequest(y=i[3], a=i[2], prior=prior, n_proc=4, n_iter=4)
            for i in insts]
    pulled = []

    def feed():
        for i, r in enumerate(reqs):
            pulled.append(i)
            yield r

    events = [(res.request_id, len(pulled), res.batch_size)
              for res in svc.stream(feed())]
    assert events[0] == (0, 2, 2) and events[1] == (1, 2, 2)
    assert events[2] == (2, 4, 2) and events[3] == (3, 4, 2)
    assert events[4] == (4, 5, 1)


def test_solve_preserves_foreign_buffered_results():
    prior = BernoulliGauss(eps=0.1)
    insts = [sample(i, 256, 64, prior) for i in range(2)]
    svc = SolveService(policy=BucketPolicy(max_batch=8),
                       rate_accounting=False, device="cpu")
    mk = lambda i: SolveRequest(y=insts[i][3], a=insts[i][2], prior=prior,
                                n_proc=4, n_iter=4)
    early = svc.submit(mk(0))
    assert [r.request_id for r in svc.solve([mk(1)])] == [early + 1]
    assert [r.request_id for r in svc.flush()] == [early]
    early2 = svc.submit(mk(0))
    assert [r.request_id for r in svc.stream([mk(1)])] == [early2 + 1]
    assert [r.request_id for r in svc.flush()] == [early2]
    # poll hands back dispatched batches only: a lone queued request waits
    late = svc.submit(mk(0))
    assert svc.poll() == []
    assert [r.request_id for r in svc.flush()] == [late]


# ---------------------------------------------------------------------------
# hot path: operand cache, singleton fast path, prewarm
# ---------------------------------------------------------------------------

def test_operand_cache_hits_and_singleton_parity():
    prior = BernoulliGauss(eps=0.1)
    _, _, a, y = sample(21, 240, 64, prior)
    svc = SolveService(policy=BucketPolicy(max_batch=4),
                       rate_accounting=False, device="cpu")
    req = SolveRequest(y=y, a=a, prior=prior, n_proc=4, n_iter=4)
    (r1,) = svc.solve([req])
    (r2,) = svc.solve([req])
    st = svc.stats()
    assert st["singleton_dispatches"] == 2
    assert st["operand_cache"]["hits"] == 1
    assert st["operand_cache"]["misses"] == 1
    np.testing.assert_array_equal(r1.x, r2.x)
    # the singleton is the plain solve of the request
    ref = single(req, te.ExactFusion())
    np.testing.assert_allclose(r1.x, ref.x, atol=1e-6)
    # a caller-vouched id replaces the content hash
    svc.solve([dataclasses.replace(req, a_id="A0")])
    svc.solve([dataclasses.replace(req, a_id="A0")])
    assert svc.stats()["operand_cache"]["hits"] == 2
    # cache off: still served
    off = SolveService(policy=BucketPolicy(max_batch=4), device="cpu",
                       rate_accounting=False, operand_cache_bytes=0)
    (r3,) = off.solve([req])
    np.testing.assert_array_equal(r3.x, r1.x)
    assert off.stats()["operand_cache"] is None


def test_zero_new_programs_after_prewarm():
    prior = BernoulliGauss(eps=0.1)
    svc = SolveService(policy=BucketPolicy(max_batch=4),
                       rate_accounting=False, device="cpu")
    menu = [PrewarmSpec(n=240, m=64, n_proc=4, n_iter=4, prior=prior,
                        batch_widths=(1, 2, 4)),
            PrewarmSpec(n=240, m=64, n_proc=4, n_iter=4, prior=prior,
                        policy="bt", batch_widths=(4,))]
    rep = svc.prewarm(menu)
    # lossless: widths 1, 2, 4 and the singleton; BT: width 4
    assert rep["programs"] == 5 and len(rep["buckets"]) == 1
    warmed = svc.compile_count()
    assert warmed == 5
    insts = [sample(40 + i, 240, 64, prior) for i in range(4)]
    reqs = [SolveRequest(y=i[3], a=i[2], prior=prior, n_proc=4, n_iter=4,
                         policy="bt" if k == 3 else "lossless")
            for k, i in enumerate(insts)]
    svc.solve(reqs)             # one BT batch of 4
    svc.solve(reqs[:2])         # lossless batch of 2
    svc.solve(reqs[:1])         # the singleton
    assert svc.compile_count() == warmed
    assert svc.stats()["prewarm"]["programs"] == 5
    th = SolveService(policy=BucketPolicy(max_batch=4), device="cpu",
                      rate_accounting=False).prewarm(menu[:1], background=True)
    th.join(timeout=120)
    assert not th.is_alive()


def test_mesh_erasure_and_bad_requests_raise():
    # the mesh is served (tests/test_torch_mesh_service.py); a service on
    # a rank other than 0, or whose batch cap the mesh does not divide,
    # still raises
    cpu_mesh = lambda rank, size: types.SimpleNamespace(
        rank=rank, size=size, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="rank 0"):
        SolveService(mesh=cpu_mesh(1, 2), device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh"):
        SolveService(mesh=cpu_mesh(0, 3), device="cpu")
    prior = BernoulliGauss(eps=0.1)
    _, _, a, y = sample(5, 256, 64, prior)
    svc = SolveService(device="cpu")
    # erasure requests are served now (tests/test_torch_erasure.py); a
    # lossy link out of range or of an unknown model still raises
    with pytest.raises(ValueError, match="erasure_rate"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=4,
                                erasure_rate=1.0))
    with pytest.raises(ValueError, match="erasure_model"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=4,
                                erasure_rate=0.1, erasure_model="burst"))
    with pytest.raises(ValueError, match="recovery"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=4,
                                erasure_rate=0.1, recovery="resend"))
    with pytest.raises(ValueError, match="policy"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=4,
                                policy="greedy"))
    with pytest.raises(ValueError, match="not divisible"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=5))
    with pytest.raises(ValueError, match="deltas"):
        svc.submit(SolveRequest(y=y, a=a, prior=prior, n_proc=4,
                                policy="fixed"))


def test_amp_serve_launcher(capsys, tmp_path):
    """``python -m repro_torch.launch.amp_serve --smoke`` on the CPU, with
    its trace and metrics dumps; ``--mesh`` with ``--hosts`` raises;
    ``--hosts 2`` serves through the cluster tier."""
    out = tmp_path / "trace.jsonl"
    met = tmp_path / "metrics.txt"
    results = tamp_serve.main(["--smoke", "--device", "cpu", "--requests",
                               "8", "--trace-out", str(out),
                               "--metrics-out", str(met)])
    assert len(results) == 16 and sorted(r.request_id for r in results) == \
        list(range(16))
    text = capsys.readouterr().out
    assert "16 requests in" in text and "se drift" in text
    assert out.read_text().count("\n") > 16
    assert "amp_requests_total" in met.read_text()
    # --mesh D is served (tests/test_torch_mesh_service.py); with --hosts
    # it still raises
    with pytest.raises(ValueError, match="--mesh"):
        tamp_serve.main(["--smoke", "--device", "cpu", "--mesh", "2",
                         "--hosts", "2"])
    results = tamp_serve.main(["--smoke", "--device", "cpu", "--hosts", "2",
                               "--requests", "8"])
    assert sorted(r.request_id for r in results) == list(range(16))
    text = capsys.readouterr().out
    assert "2 hosts on cpu" in text and "router: served" in text


def test_red_reference_het_batch_is_a_cell_flip():
    """Why the reference's ``test_heterogeneous_batch_matches_single`` is
    red (ROADMAP.md Queue 3), on its own inputs (``PRNGKey(2)``, the BT
    request: eps 0.10, 15 dB, N=500, M=150, P=5, T=5): the reference's
    single solve parts from its batched solve from iteration 2 on (a
    message rounded differently lands in the neighbouring quantizer cell;
    the BT bins then follow), while the port's batched and single solves
    agree to float32 rounding and both follow the reference's batch."""
    from repro.core.amp import sample_problem as j_sample
    from repro.core.engine import (AmpEngine as JEngine,
                                   BTRateControl as JBT,
                                   EcsqTransport as JEcsq,
                                   EngineConfig as JConfig)
    from repro.core.state_evolution import CSProblem as JProblem

    eps, snr, n, m, p, t = 0.10, 15.0, 500, 150, 5, 5
    jprior = jd.BernoulliGauss(eps)
    jprob = JProblem(n=n, m=m, prior=jprior, snr_db=snr)
    _, a, y = j_sample(jax.random.PRNGKey(2), n, m, jprior, jprob.sigma_e2)
    a, y = np.asarray(a), np.asarray(y)
    j_single = JEngine(jprior, JConfig(n_proc=p, n_iter=t,
                                       collect_symbols=False), JEcsq(),
                       JBT(jprob, p, t, 1.005, 6.0, "ecsq")).solve(y, a)
    j_batch = jserving.SolveService(
        policy=jserving.BucketPolicy(max_batch=8)).solve(
        [jserving.SolveRequest(y=y, a=a, prior=jprior, snr_db=snr,
                               n_proc=p, n_iter=t, policy="bt")])[0]
    prior = BernoulliGauss(eps)
    req = SolveRequest(y=y, a=a, prior=prior, snr_db=snr, n_proc=p,
                       n_iter=t, policy="bt")
    t_single = single(req, controller=te.BTRateControl(
        req.problem(), p, t, 1.005, 6.0, "ecsq"))
    t_batch = SolveService(policy=BucketPolicy(max_batch=8),
                           device="cpu").solve([req])[0]
    rel = lambda u, v: np.abs(np.asarray(u) / np.asarray(v) - 1)
    # the reference parts from itself at iteration 2, past its test's 1e-4
    # by the last iteration
    ref_gap = rel(j_batch.sigma2_hat, j_single.sigma2_hat)
    assert ref_gap[:2].max() < 1e-6 and ref_gap[2] > 1e-5
    assert ref_gap[-1] > 1e-4
    # the port: batch == single, and both on the reference's batch
    assert rel(t_batch.sigma2_hat, t_single.sigma2_hat).max() < 1e-6
    assert rel(t_batch.sigma2_hat, j_batch.sigma2_hat).max() < 1e-5
    np.testing.assert_allclose(t_batch.deltas, j_batch.deltas, rtol=1e-5)
