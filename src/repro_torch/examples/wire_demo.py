"""rANS wire demo on the port: close the loop on the paper's rate claims
end to end (the twin of the JAX package's ``examples/wire_demo.py``).

The paper accounts coding rate as the ECSQ entropy H_Q, "achievable
through entropy coding". Run a BT-MP-AMP solve, take the realized
quantizer symbol streams of every iteration, entropy-code them per
processor with the rANS coder (``core/entropy_code.RansCodec``), and
compare

    actual rANS bits  vs  empirical entropy  vs  model H_Q  vs  int8 wire

per iteration and in total. The actual bitstream lands within a few
bytes a processor of the empirical entropy (static-model rANS overhead:
state flush and frequency quantization), which in turn tracks the model
H_Q the BT controller optimizes. The int8 column is what the fixed-width
block-quantized transport would spend instead. On the card every
local-computation step is the fused row kernel (K1).

  PYTHONPATH=src python -m repro_torch.examples.wire_demo [--smoke]
      [--seed 0] [--device cpu]

``--smoke`` shrinks the problem; its assertions make the demo a
regression check on the whole accounting chain (symbols -> codec -> bytes
-> H_Q).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.denoisers import BernoulliGauss
from ..core.engine import AmpEngine, BTRateControl, EcsqTransport, EngineConfig
from ..core.entropy_code import RansCodec
from ..core.state_evolution import CSProblem
from .common import check_device, draw_problem

__all__ = ["empirical_entropy", "run", "main"]

EPS = 0.05
SMOKE_SIZE = (800, 240, 6, 6)
FULL_SIZE = (2000, 600, 10, 10)     # kappa 0.3, the paper's Sec. 4 point
INT8_WIRE = 8.0 + 16.0 / 512        # int8 + amortized bf16 scale a block


def empirical_entropy(sym: np.ndarray) -> float:
    _, counts = np.unique(sym.astype(np.int64), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def run(device: str = "cuda", smoke: bool = False, seed: int = 0,
        problem=None) -> dict:
    """The BT solve and its wire accounting. With ``smoke`` the problem is
    the small one and the reference's assertions hold (they raise)."""
    check_device(device)
    n, m, p, t = SMOKE_SIZE if smoke else FULL_SIZE
    prior = BernoulliGauss(eps=EPS)
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=20.0)
    s0, a, y = draw_problem(seed, prob, device, problem)

    ctrl = BTRateControl(prob, p, t, c_ratio=1.005, r_max=6.0)
    eng = AmpEngine(prior,
                    EngineConfig(n_proc=p, n_iter=t, collect_symbols=True,
                                 collect_xs=True, device=device),
                    EcsqTransport(), ctrl)
    tr = eng.solve(y, a)
    rows = []
    tot_hq = tot_emp = tot_rans = 0.0
    checked_roundtrip = False
    for it in range(t):
        if not np.isfinite(tr.deltas[it]):
            rows.append({"t": it, "delta": float(tr.deltas[it])})
            continue
        syms = np.asarray(tr.symbols[it], np.int64)       # (P, N)
        # per-processor streams: each processor codes its own messages
        # with its own static model, exactly what the cluster would do
        bits = 0
        for proc in range(p):
            stream = syms[proc]
            shifted = stream - stream.min()                # rANS alphabet
            codec = RansCodec(np.bincount(shifted))
            bits += codec.encoded_bits(shifted)
            if not checked_roundtrip:
                enc = codec.encode(shifted)
                dec = codec.decode(enc, len(shifted))
                assert (dec == shifted).all(), "rANS round-trip failed"
                checked_roundtrip = True
        r_rans = bits / (p * n)
        r_emp = float(np.mean([empirical_entropy(syms[q])
                               for q in range(p)]))
        r_hq = float(tr.rates[it])
        rows.append({"t": it, "delta": float(tr.deltas[it]), "h_q": r_hq,
                     "h_emp": r_emp, "rans": r_rans, "int8": INT8_WIRE})
        tot_hq += r_hq
        tot_emp += r_emp
        tot_rans += r_rans
        if smoke:
            # the paper's claim, as inequalities on realized bytes: the
            # coder may not beat the empirical entropy of its own stream,
            # and its overhead is a few bytes a processor (state flush +
            # 12-bit frequency table quantization)
            assert r_rans >= r_emp - 1e-6, (it, r_rans, r_emp)
            assert r_rans <= r_emp + 0.1 + 64.0 * 8 / n, (it, r_rans, r_emp)
    n_coded = int(np.isfinite(tr.deltas).sum())
    if smoke:
        assert checked_roundtrip
        assert tot_rans > 0
    return {"n": n, "m": m, "n_proc": p, "n_iter": t, "eps": EPS,
            "final_mse": float(tr.mse(s0)[-1]), "rows": rows,
            "n_coded": n_coded, "total_h_q": tot_hq, "total_emp": tot_emp,
            "total_rans": tot_rans, "total_int8": n_coded * INT8_WIRE,
            "roundtrip_checked": checked_roundtrip, "smoke": smoke,
            "deltas": tr.deltas, "rates": tr.rates,
            "sigma2_hat": tr.sigma2_hat, "mse": tr.mse(s0), "x": tr.x,
            "symbols": tr.symbols}


def report(r: dict) -> None:
    print(f"BT-MP-AMP solve: N={r['n']} M={r['m']} P={r['n_proc']} "
          f"T={r['n_iter']} eps={r['eps']} 20dB  final MSE "
          f"{r['final_mse']:.3e}")
    print(f"\n{'t':>3s} {'delta':>9s} {'H_Q model':>10s} {'H_emp':>8s} "
          f"{'rANS':>8s} {'int8 wire':>10s}   (bits/elem/proc)")
    for row in r["rows"]:
        if "h_q" not in row:
            print(f"{row['t']:3d} {'lossless':>9s}")
            continue
        print(f"{row['t']:3d} {row['delta']:9.4f} {row['h_q']:10.3f} "
              f"{row['h_emp']:8.3f} {row['rans']:8.3f} {row['int8']:10.3f}")
    print(f"\ntotals over {r['n_coded']} coded iterations: "
          f"H_Q {r['total_h_q']:.2f}, empirical {r['total_emp']:.2f}, "
          f"rANS {r['total_rans']:.2f}, int8 wire {r['total_int8']:.2f}")
    if r["total_rans"] > 0:
        print(f"rANS spends {r['total_rans'] / r['total_h_q']:.3f}x the "
              f"model H_Q and {r['total_rans'] / r['total_int8']:.2f}x the "
              f"int8 wire ({r['total_int8'] / r['total_rans']:.1f}x saving "
              f"vs fixed-width transport)")
    if r["smoke"]:
        print("smoke assertions passed")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small problem + assertions (wire-accounting "
                         "regression)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the solve runs (default: the card)")
    args = ap.parse_args(argv)
    r = run(device=args.device, smoke=args.smoke, seed=args.seed)
    report(r)
    return r


if __name__ == "__main__":
    main()
