"""The port's LM train step on worlds of gloo ranks (``launch/steps.py`` over
``launch/mesh.py::GridMesh``), spawned processes on the CPU, one thread
each, every join under a deadline (``tests/torch_spmd.py::run_world``; the
ranks run ``tests/torch_train.py``). Both worlds start at once.

  * (pod=2, data=2) exact fusion with ZeRO-1 == the world of one on the
    global batch (its microbatch i the rows rank i holds): the same bf16
    gradients of each microbatch, summed in another order, so the loss,
    the gradient norm and the state agree to float32 reduction order
    (1e-6 relative; parameters exact but where a master weight sits on a
    bf16 rounding boundary: at most one bf16 ulp, on under 0.1 % of them);
  * ZeRO-1: each rank holds a quarter of the optimizer state's bytes,
    every leaf sliced (each has a dimension that 4 divides), and the
    gathered state is the whole one;
  * int8 over "pod": its collectives carry uint8 payloads only, those over
    "data" and the norm's float32;
  * the intent of the reference's two red tests
    (``tests/test_solver_distributed.py::test_train_step_lowers_on_small_mesh``
    and ``::test_compressed_gradient_training_converges``, which die in
    XLA's SPMD partitioner here, ROADMAP Queue 3): the compressed step
    runs on a pod mesh, and over 12 steps at lr 2e-3 the exact and the
    int8 losses both drop by at least 0.3 and end within 0.5 of each
    other (the reference's own bounds);
  * ``compressed_grad_transform`` (world (pod=2) and (pod=4)) == an
    emulation built from the reference's ``quantize_blocks`` /
    ``dequantize_blocks``: the residual bit for bit (a rank's own
    quantization), the reduced sum to 1e-6 of its scale (the emulation
    sums the ranks' dequantized chunks with XLA's reduction, the port in
    rank order), the same bits on every rank, two rounds of error
    feedback.
"""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.compression as jc

import torch_spmd
import torch_train

POD_DATA = ((2, 2, 1), ("pod", "data", "model"))
ZERO_RTOL = 1e-6
PSUM_RTOL = 1e-6
LEAVES = {"a/w": (6, 40), "b": (700,), "c/stack": (2, 3, 130)}


def _grads(d, seed=3):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * (1 + r)).astype(np.float32)
             for k, s in LEAVES.items()} for r in range(d)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The train world of 4 and the grad-transform worlds of 2 and 4, all
    started at once."""
    tmp = tmp_path_factory.mktemp("train_worlds")
    jobs = {
        "train": (torch_train.train_cases, 4, tmp / "t",
                  *POD_DATA),
        "gt2": (torch_train.grad_transform_cases, 2, tmp / "g2", (2, 1),
                ("pod", "data"), _grads(2), 8, 128),
        "gt4": (torch_train.grad_transform_cases, 4, tmp / "g4", (4,),
                ("pod",), _grads(4), 4, 64),
    }
    for _, _, path, *_ in jobs.values():
        path.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(torch_spmd.run_world, fn, world, path, *args)
                for name, (fn, world, path, *args) in jobs.items()}
        return {name: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                for name, f in futs.items()}


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def test_pod_data_exact_equals_world_of_one(worlds):
    ranks = worlds["train"]
    one = ranks[0]["single"]
    for r in ranks:
        ex = r["exact"]
        _rel_close(ex["losses"], one["losses"], ZERO_RTOL)
        for key in ("loss", "grad_norm", "clip"):
            _rel_close(ex["first"][key], one["first"][key], ZERO_RTOL)
        for k, want in one["params"].items():
            # every rank the same bits, after the all-gather
            np.testing.assert_array_equal(ex["params"][k],
                                          ranks[0]["exact"]["params"][k])
            d = np.abs(ex["params"][k] - want)
            assert np.all(d <= 2.0 ** -7 * np.abs(want)), k
            assert np.mean(d > 0) < 1e-3, (k, np.mean(d > 0))
        for key in ("master", "m", "v"):
            for k, want in one["opt_full"][key].items():
                _rel_close(ex["opt_full"][key][k], want, ZERO_RTOL)


def test_zero1_keeps_a_quarter_of_the_state(worlds):
    ranks = worlds["train"]
    full = ranks[0]["single"]["state_bytes"]
    dims = ranks[0]["exact"]["zero_dims"]
    assert all(d is not None for d in dims.values()), dims
    for r in ranks:
        assert r["exact"]["state_bytes"] * 4 == full


def test_int8_step_moves_int8_over_pod_and_float32_over_data(worlds):
    for r in worlds["train"]:
        st = r["int8_stats"]
        pod, data = st["pod"]["bytes"], st["data"]["bytes"]
        assert set(pod) == {"all_to_all", "all_gather", "all_reduce"}, pod
        assert set(pod["all_to_all"]) == {"uint8"}
        assert set(pod["all_gather"]) == {"uint8"}
        # the pod's all-reduce is the loss alone (one float32)
        assert pod["all_reduce"] == {"float32": 4}
        assert set(data) == {"all_reduce"} and \
            set(data["all_reduce"]) == {"float32"}
        # 11 gradient leaves and the loss over "data"
        assert st["data"]["calls"]["all_reduce"] == 12
        # ZeRO-1 over pod x data: the norm's sums and the parameters
        assert st["zero"]["calls"] == {"all_reduce": 1, "all_gather": 11}
        assert set(st["zero"]["bytes"]["all_gather"]) == {"uint8"}
        assert r["int8_first"]["quant_noise"] > 0


def test_reference_reds_intent_int8_tracks_exact(worlds):
    """The reference's bounds (tests/test_solver_distributed.py:139-142)."""
    for r in worlds["train"]:
        exact, int8 = r["converge"][None], r["converge"][8]
        assert exact == worlds["train"][0]["converge"][None]
        assert exact[-1] < exact[0] - 0.3, exact
        assert int8[-1] < int8[0] - 0.3, int8
        assert abs(int8[-1] - exact[-1]) < 0.5, (exact[-1], int8[-1])
        assert int8 != exact


def _ref_round(xs_by_leaf, res_by_leaf, bits, block):
    """One round of the reference's ``compressed_grad_transform`` for every
    rank at once, its collective emulated on stacked arrays by its own
    ``quantize_blocks`` / ``dequantize_blocks``."""
    qc = jc.QuantConfig(bits, block)
    reduced, residual, noise = {}, {}, None
    for k in sorted(xs_by_leaf):
        g_fb = [g + r for g, r in zip(xs_by_leaf[k], res_by_leaf[k])]
        d = len(g_fb)
        flat = jnp.stack([jnp.asarray(g).reshape(-1) for g in g_fb])
        flat, _ = jc._pad_to(flat, d * block * 2)
        chunks = flat.reshape(d, d, -1)
        q, s = jc.quantize_blocks(chunks, qc)
        sf = s.astype(jnp.float32)
        n1 = jnp.mean(sf * sf, axis=(1, 2)) / 12.0 * d
        own = jc.dequantize_blocks(q, s, qc).sum(axis=0)
        q2, s2 = jc.quantize_blocks(own, qc)
        s2f = s2.astype(jnp.float32)
        n2 = jnp.mean(s2f * s2f, axis=1) / 12.0
        full = jc.dequantize_blocks(q2, s2, qc).reshape(-1)
        reduced[k] = np.asarray(full[:g_fb[0].size]).reshape(g_fb[0].shape)
        residual[k] = []
        for g in g_fb:
            qr, sr = jc.quantize_blocks(jnp.asarray(g).reshape(1, -1), qc)
            deq = jc.dequantize_blocks(qr, sr, qc, orig_len=g.size)
            residual[k].append(g - np.asarray(deq).reshape(g.shape))
        nv = np.asarray(n1 + n2)
        noise = nv if noise is None else noise + nv
    return reduced, residual, noise


@pytest.mark.parametrize("world,bits,block", [("gt2", 8, 128),
                                              ("gt4", 4, 64)])
def test_compressed_grad_transform_matches_reference_emulation(
        worlds, world, bits, block):
    ranks = worlds[world]
    d = len(ranks)
    grads = _grads(d)
    xs = {k: [grads[r][k] for r in range(d)] for k in LEAVES}
    res = {k: [np.zeros_like(v) for v in xs[k]] for k in LEAVES}
    for rnd in range(2):
        reduced, res, noise = _ref_round(xs, res, bits, block)
        for r in ranks:
            got = r["rounds"][rnd]
            for k in LEAVES:
                np.testing.assert_array_equal(
                    got["reduced"][k], ranks[0]["rounds"][rnd]["reduced"][k])
                _rel_close(got["reduced"][k], reduced[k], PSUM_RTOL)
                np.testing.assert_array_equal(got["residual"][k],
                                              res[k][r["rank"]])
            _rel_close(got["noise"], noise[r["rank"]], PSUM_RTOL)
        # the sum stays near the exact one (the reference's bound)
        for k in LEAVES:
            want = np.sum(xs[k], axis=0)
            rel = np.abs(reduced[k] - want).max() / np.abs(want).max()
            assert rel < (0.02 if bits == 8 else 0.25), (k, rel)
    for r in ranks:
        assert all(set(v) == {"uint8"} for op, v in r["stats"]["bytes"].items()
                   if op in ("all_to_all", "all_gather"))
