"""The port's twins of the wire and cluster examples
(``repro_torch.examples``: wire_demo, mp_amp_cluster) on the CPU, as
``test_torch_examples_amp.py`` holds the other three (its docstring gives
the tolerances): wire_demo's ``--smoke`` assertions pass and its first
iteration's symbols are the reference's; mp_amp_cluster's part 1 against
the reference's centralized, BT and DP solves; part 2 over 2 gloo ranks,
its exact fusion equal to the port's local lossless solve within 1e-5 and
int8 under 1.3 x the exact MSE; each twin's ``main`` with ``--device
cpu``, and raising without a card at its default device.
"""
import numpy as np
import pytest

import repro.core.amp as jamp
import repro.core.denoisers as jd
import repro.core.engine as je
import repro.core.mp_amp as jmp
import repro.core.rate_alloc as jra
import repro.core.rate_distortion as jrd
import repro.core.state_evolution as jse
from repro_torch.core.mp_amp import MPAMPConfig, mp_amp_solve
from repro_torch.core.denoisers import BernoulliGauss
from repro_torch.examples import mp_amp_cluster, wire_demo
from torch_examples import (LOSSLESS_RTOL, draw, lossless_close,
                            statistically_close)


# -- wire_demo -------------------------------------------------------------------

@pytest.fixture(scope="module")
def wire():
    n, m, p, t = wire_demo.SMOKE_SIZE
    s0, a, y = draw(30, n, m, wire_demo.EPS)
    got = wire_demo.run(device="cpu", smoke=True, problem=(s0, a, y))
    prior = jd.BernoulliGauss(eps=wire_demo.EPS)
    prob = jse.CSProblem(n=n, m=m, prior=prior, snr_db=20.0)
    eng = je.AmpEngine(prior, je.EngineConfig(
        n_proc=p, n_iter=t, collect_symbols=True, collect_xs=True),
        je.EcsqTransport(), je.BTRateControl(prob, p, t, c_ratio=1.005,
                                             r_max=6.0))
    return got, eng.solve(y, a), s0


def test_wire_demo_smoke_assertions_pass(wire):
    got, _, _ = wire
    # run(smoke=True) raises where the reference's assertions fail
    assert got["smoke"] and got["roundtrip_checked"]
    coded = [r for r in got["rows"] if "rans" in r]
    assert len(coded) == got["n_coded"] > 0
    for r in coded:
        assert r["h_emp"] - 1e-6 <= r["rans"] <= \
            r["h_emp"] + 0.1 + 64.0 * 8 / got["n"]
    assert got["total_rans"] == pytest.approx(sum(r["rans"] for r in coded))
    assert got["total_int8"] == pytest.approx(
        got["n_coded"] * (8.0 + 16.0 / 512))


class _WireTrace:
    """wire_demo's returned trace in ``EngineTrace``'s shape."""

    def __init__(self, got):
        self.sigma2_hat, self.deltas = got["sigma2_hat"], got["deltas"]
        self.rates, self.symbols = got["rates"], got["symbols"]
        self.x, self._mse = got["x"], got["mse"]

    def mse(self, _s0):
        return self._mse


def test_wire_demo_trace_matches_reference(wire):
    """The first iteration's symbols are the reference's (the same
    lossless iterate, the same bin within 1e-4); after that the BT runs
    part (``statistically_close``), and the rates with them."""
    got, want, s0 = wire
    np.testing.assert_array_equal(got["symbols"][0],
                                  np.asarray(want.symbols)[0])
    statistically_close(got["mse"], want.mse(s0), got["deltas"],
                        want.deltas, got["sigma2_hat"], want.sigma2_hat)
    fin = np.isfinite(np.asarray(want.rates))
    np.testing.assert_allclose(np.sum(got["rates"][fin]),
                               np.sum(np.asarray(want.rates)[fin]),
                               rtol=0.05)


# -- mp_amp_cluster ---------------------------------------------------------------

P1_SIZE = (1500, 450)        # 450 rows over P = 30
P2_SIZE = (400, 120)


@pytest.fixture(scope="module")
def cluster1():
    n, m = P1_SIZE
    s0, a, y = draw(40, n, m, mp_amp_cluster.EPS1)
    got = mp_amp_cluster.part1(device="cpu", problem=(s0, a, y))
    prior = jd.BernoulliGauss(eps=mp_amp_cluster.EPS1)
    prob = jse.CSProblem(n=n, m=m, prior=prior)
    t, p = jse.PAPER_T[mp_amp_cluster.EPS1], mp_amp_cluster.P1
    rd, mm = jrd.RDModel(prior), jd.make_mmse_interp(prior)
    cfg = jmp.MPAMPConfig(p, t)
    cen = jamp.amp_solve(y, a, prior, t, s0=s0)
    bt = jmp.mp_amp_solve(y, a, prior, cfg, jra.BTController(
        prob, p, t, 1.005, 6.0, "ecsq", mmse_fn=mm), s0=s0)
    dp = jra.dp_allocate(prob, p, t, 2.0 * t, rd=rd, mmse_fn=mm)
    deltas = je.DPSchedule(dp, rd, p).deltas
    dps = jmp.mp_amp_solve(y, a, prior, cfg, deltas, s0=s0,
                           sigma2_for_model=dp.sigma2_d[:-1])
    return got, {"centralized": cen, "bt": bt, "dp": dps, "deltas": deltas}


def test_cluster_part1_matches_reference(cluster1):
    got, want = cluster1
    lossless_close(got["x"]["centralized"], want["centralized"].x,
                   got["mse"]["centralized"], want["centralized"].mse)
    # the DP plan is float64 numpy on both sides
    np.testing.assert_allclose(got["dp_deltas_planned"], want["deltas"],
                               rtol=1e-6)
    for key in ("bt", "dp"):
        w = want[key]
        statistically_close(got["mse"][key], w.mse, got["deltas"][key],
                            w.deltas)
        np.testing.assert_allclose(got["bits_" + key],
                                   w.total_bits_empirical, rtol=0.05)
    # the DP's bins are its plan, on both sides
    np.testing.assert_allclose(got["deltas"]["dp"], want["dp"].deltas,
                               rtol=1e-6)
    assert got["paper_bits"] == {"bt": 49.19, "dp": 22.55}


@pytest.fixture(scope="module")
def cluster2():
    n, m = P2_SIZE
    s0, a, y = draw(41, n, m, mp_amp_cluster.EPS2)
    got = mp_amp_cluster.part2(device="cpu", ranks=2, problem=(s0, a, y))
    local = mp_amp_solve(y, a, BernoulliGauss(eps=mp_amp_cluster.EPS2),
                         MPAMPConfig(2, mp_amp_cluster.T2, device="cpu"),
                         [np.inf] * mp_amp_cluster.T2, s0=s0)
    return got, local, s0


def test_cluster_part2_exact_is_the_local_lossless_solve(cluster2):
    got, local, s0 = cluster2
    rows = {r["label"].strip(): r for r in got["rows"]}
    exact = rows["exact fusion"]
    assert np.abs(exact["x"] - local.x).max() <= \
        LOSSLESS_RTOL * np.abs(local.x).max()
    np.testing.assert_allclose(exact["sigma2_hat"], local.sigma2_hat,
                               rtol=LOSSLESS_RTOL)
    assert exact["noise_var"] == 0.0
    assert rows["int8 compressed psum"]["mse"] < 1.3 * exact["mse"]
    assert rows["int4 compressed psum"]["noise_var"] > \
        rows["int8 compressed psum"]["noise_var"] > 0
    assert rows["int8 + 15% straggler"]["mse"] < 0.5 * BernoulliGauss(
        eps=mp_amp_cluster.EPS2).second_moment
    assert all(r["ranks_agree"] for r in got["rows"])
    assert got["ranks"] == len(got["launches"]) == 2
    # on the CPU no kernel launches: the wrappers ran their plain versions
    assert not any(v for rank in got["launches"] for v in rank.values())


# -- main() of each twin -----------------------------------------------------------

def test_wire_demo_main_smoke(capsys):
    wire_demo.main(["--device", "cpu", "--smoke"])
    assert "smoke assertions passed" in capsys.readouterr().out


def test_mp_amp_cluster_main_part2(monkeypatch, capsys):
    monkeypatch.setattr(mp_amp_cluster, "N2", P2_SIZE[0])
    monkeypatch.setattr(mp_amp_cluster, "M2", P2_SIZE[1])
    r = mp_amp_cluster.main(["--device", "cpu", "--part", "2",
                             "--ranks", "2"])
    out = capsys.readouterr().out
    assert "Part 2" in out and "int8 + 15% straggler" in out
    assert len(r["part2"]["rows"]) == 4



@pytest.mark.parametrize("twin", [wire_demo, mp_amp_cluster],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_raises_without_a_card(twin):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main([])
