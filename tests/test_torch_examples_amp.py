"""The port's twins of the single-process solver examples
(``repro_torch.examples``: quickstart, serve_mixed, observe) on the CPU,
each ``run(device="cpu")`` held against the same calls of the JAX package
that its reference example makes, on one problem drawn with numpy from a
seed and carried into both packages; and each twin's ``main`` run with
``--device cpu``, and raising without a card at its default device.
wire_demo and mp_amp_cluster are in ``test_torch_examples_cluster.py``
(the two files split one file's fixed costs, every BT controller's rate
table built in both packages, between two workers).

Tolerances (ROADMAP.md's ground rules): a lossless solve is the same
float32 arithmetic in another order, its x and MSE trajectory within 1e-5
relative (x against its largest magnitude). A quantized solve (BT, DP, a
fixed bin) parts from the reference's at its first quantizer cell that the
other rounding flips, so it is held statistically, as
``test_torch_frontends.py::test_mp_amp_solve_with_bt_controller`` holds
it: ``sigma2_hat`` within 10 %, the final MSE within 1 dB and the bits
within 5 %; the first bin within 1e-4 (``torch_examples.statistically_close``
says why later bins are not compared one by one). Bucket keys and
span-name trees are equal, and the drift alert falls on the same request.
"""
import os

import numpy as np
import pytest

import repro.core.amp as jamp
import repro.core.denoisers as jd
import repro.core.mp_amp as jmp
import repro.core.rate_alloc as jra
import repro.core.state_evolution as jse
import repro.serving as jserving
import repro.telemetry as jtel
from repro_torch.examples import observe, quickstart, serve_mixed
from torch_examples import (LOSSLESS_RTOL, draw, lossless_close,
                            statistically_close)


# -- quickstart ----------------------------------------------------------------

QS = dict(n=1000, m=300, n_proc=10, n_iter=8)


@pytest.fixture(scope="module")
def quick():
    s0, a, y = draw(0, QS["n"], QS["m"], quickstart.EPS)
    got = quickstart.run(device="cpu", problem=(s0, a, y),
                         n_proc=QS["n_proc"], n_iter=QS["n_iter"])
    prior = jd.BernoulliGauss(eps=quickstart.EPS, mu_s=0.0, sigma_s=1.0)
    prob = jse.CSProblem(n=QS["n"], m=QS["m"], prior=prior,
                         snr_db=quickstart.SNR_DB)
    t, p = QS["n_iter"], QS["n_proc"]
    cen = jamp.amp_solve(y, a, prior, t, s0=s0)
    lossless = jmp.mp_amp_solve(y, a, prior, jmp.MPAMPConfig(p, t),
                                [np.inf] * t, s0=s0)
    ctrl = jra.BTController(prob, p, t, c_ratio=1.005, r_max=6.0,
                            rate_model="ecsq",
                            mmse_fn=jd.make_mmse_interp(prior))
    bt = jmp.mp_amp_solve(y, a, prior, jmp.MPAMPConfig(p, t), ctrl, s0=s0)
    return got, {"centralized": cen, "lossless": lossless, "bt": bt}, prior


@pytest.mark.parametrize("solve", ["centralized", "lossless"])
def test_quickstart_lossless_solves_match_reference(quick, solve):
    got, want, _ = quick
    lossless_close(got["x"][solve], want[solve].x, got["mse"][solve],
                   want[solve].mse)


def test_quickstart_bt_matches_reference_statistically(quick):
    got, want, prior = quick
    bt = want["bt"]
    statistically_close(got["mse"]["bt"], bt.mse, got["deltas_bt"],
                        bt.deltas, got["sigma2_hat"]["bt"], bt.sigma2_hat)
    np.testing.assert_allclose(got["bits_bt"], bt.total_bits_empirical,
                               rtol=0.05)
    np.testing.assert_allclose(got["bits_bt_analytic"],
                               bt.total_bits_analytic, rtol=0.05)
    assert max(got["rates_bt"]) <= 6.0 + 1e-4


def test_quickstart_printed_numbers(quick):
    got, want, prior = quick
    sdr = lambda mse: 10 * np.log10(prior.second_moment / mse)
    for key, solve in (("sdr_centralized", "centralized"),
                       ("sdr_lossless", "lossless"), ("sdr_bt", "bt")):
        assert abs(got[key] - sdr(want[solve].mse[-1])) < \
            (1e-3 if solve != "bt" else 1.0), key
    assert got["max_dx_lossless"] <= 1e-4
    assert got["saved_pct"] == pytest.approx(
        100 * (1 - got["bits_bt"] / (32 * QS["n_iter"])))
    assert len(got["rates_bt"]) == QS["n_iter"]


# -- serve_mixed ----------------------------------------------------------------

def _mixed_request(spec, a, y):
    eps, snr, n, m, p, t, policy = spec
    kw = {}
    if policy == "fixed":
        deltas = np.full(t, 0.05, np.float32)
        deltas[0] = np.inf
        kw["deltas"] = deltas
    return jserving.SolveRequest(y=y, a=a, prior=jd.BernoulliGauss(eps=eps),
                                 snr_db=snr, n_proc=p, n_iter=t,
                                 policy=policy, **kw)


@pytest.fixture(scope="module")
def mixed():
    specs = serve_mixed.SPECS
    problems = [draw(10 + i, n, m, eps, snr)
                for i, (eps, snr, n, m, p, t, _) in enumerate(specs)]
    got = serve_mixed.run(device="cpu", problems=problems)
    svc = jserving.SolveService(policy=jserving.BucketPolicy(max_batch=32))
    want = svc.solve([_mixed_request(spec, a, y)
                      for spec, (_, a, y) in zip(specs, problems)])
    return got, want, problems


def test_serve_mixed_buckets_match_reference(mixed):
    got, want, _ = mixed
    for row, res in zip(got["requests"], want):
        b, w = row["bucket"], res.bucket
        assert (b.n_pad, b.m_pad, b.n_proc, b.t_max, b.layout) == \
            (w.n_pad, w.m_pad, w.n_proc, w.t_max, w.layout)
        assert row["bucket_label"] == (
            f"({w.n_pad},{w.m_pad},{w.n_proc},{w.t_max}){w.layout[0]}")
    assert got["n_buckets"] == len({r.bucket for r in want}) == 4
    assert got["n_requests"] == len(want)


@pytest.mark.parametrize("i", range(len(serve_mixed.SPECS)))
def test_serve_mixed_results_match_reference(mixed, i):
    got, want, problems = mixed
    row, res = got["requests"][i], want[i]
    s0 = problems[i][0]
    assert (row["bits"] is None) == (not res.tracked)
    if row["policy"] == "lossless":
        assert np.abs(row["x"] - res.x).max() <= \
            LOSSLESS_RTOL * np.abs(res.x).max()
        np.testing.assert_allclose(row["sigma2_hat"], res.sigma2_hat,
                                   rtol=LOSSLESS_RTOL)
        np.testing.assert_allclose(row["mse"], res.mse(s0),
                                   rtol=LOSSLESS_RTOL)
        return
    np.testing.assert_allclose(row["sigma2_hat"], res.sigma2_hat, rtol=0.10)
    assert abs(10 * np.log10(row["mse"] / res.mse(s0))) < 1.0
    np.testing.assert_allclose(row["bits"], res.total_bits, rtol=0.05)


# -- observe --------------------------------------------------------------------

@pytest.fixture(scope="module")
def observed(tmp_path_factory):
    specs = observe.SPECS
    problems = [draw(20 + i, n, m, eps, snr_true)
                for i, (eps, snr_true, _, n, m, p, t) in enumerate(specs)]
    path = str(tmp_path_factory.mktemp("observe") / "trace.jsonl")
    got = observe.run(device="cpu", problems=problems, trace_out=path)
    svc = jserving.SolveService(policy=jserving.BucketPolicy(max_batch=32),
                                telemetry=True)
    want = svc.solve([
        jserving.SolveRequest(y=y, a=a, prior=jd.BernoulliGauss(eps=eps),
                              snr_db=snr_decl, n_proc=p, n_iter=t,
                              policy="lossless")
        for (eps, _, snr_decl, n, m, p, t), (_, a, y)
        in zip(specs, problems)])
    return got, want, svc.metrics_text(), path


def test_observe_span_trees_and_alert_match_reference(observed):
    got, want, _, _ = observed
    for row, res in zip(got["requests"], want):
        assert row["tree"] == jtel.span_names(res.spans)
        assert [name for name, _ in row["spans_ms"]] == \
            [s[0] for s in res.spans]
        assert all(ms >= 0 for _, ms in row["spans_ms"])
        want_alert = (res.se_drift is not None
                      and res.se_drift > jtel.DRIFT_ALERT)
        assert row["alert"] == want_alert
        assert np.abs(row["x"] - res.x).max() <= \
            LOSSLESS_RTOL * np.abs(res.x).max()
    # the request that declares 0 dB for a 20 dB signal, and only it
    assert [row["alert"] for row in got["requests"]] == [False, True, False]


def test_observe_metrics_and_trace(observed):
    got, _, text, path = observed
    want = [line for line in text.splitlines()
            if "se_drift" in line or "requests_total" in line]
    name = lambda line: line.split("{")[0].split(" ")[0 if line[0] != "#"
                                                       else 2]
    assert [name(line) for line in got["prometheus"]] == \
        [name(line) for line in want]
    assert len(got["latency_p95_s"]) >= 1
    assert all(q > 0 for q in got["latency_p95_s"])
    with open(path) as fh:
        assert sum(1 for _ in fh) == got["trace_events"] > 0


# -- main() of each twin -----------------------------------------------------------

def test_quickstart_main(monkeypatch, capsys):
    for key, v in (("N", 600), ("M", 180), ("N_PROC", 6), ("N_ITER", 5)):
        monkeypatch.setattr(quickstart, key, v)
    r = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "MP-AMP lossless fusion" in out and "per-iteration rates" in out
    assert r["n"] == 600 and len(r["rates_bt"]) == 5


def test_serve_mixed_main(capsys):
    r = serve_mixed.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{len(serve_mixed.SPECS)} requests ran as {r['n_buckets']}" in out


def test_observe_main(tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    r = observe.main(["--device", "cpu", "--trace-out", path])
    out = capsys.readouterr().out
    assert "ALERT" in out and os.path.exists(path)
    assert [row["alert"] for row in r["requests"]] == [False, True, False]



@pytest.mark.parametrize("twin", [quickstart, serve_mixed, observe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_raises_without_a_card(twin):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
