"""The port's sharded LM serving step (``launch/steps.py::build_serve_step``)
against the world of one, on gloo worlds of 2 and 4 ranks on the CPU
(spawned processes, one thread each, every join under a deadline:
``tests/torch_spmd.py::run_world``; the ranks run
``tests/torch_serve_tp.py``). The three worlds start at once.

Smoke configs of gemma3-1b (one KV head; window 32: at (1, 2) a cache of
64 rows, 32 a rank, so the first decode step's local window crosses the
slice edge and the last one leaves rank 0 no row), qwen2-vl (M-RoPE, the
vision stub), qwen3-moe (experts over "model"), mixtral with 3 experts
("expert_mlp") and rwkv6 (heads over "model"), parameters in float32:
prefill's last-64 logits and caches, then 4 greedy decode steps (logits
and ids), at (data 1, model 2) and (2, 2), each rank's rows against the
world of one's within 1e-5 of their scale, the ids equal. Also: B=1 at
(2, 2), its cache over ("data", "model"), 18 rows a rank; a cache length
(65) that "model" does not divide (whole on each rank, K5's one-device
form); rglru and whisper at model 2 (their LRU columns and heads over
"model"); and every family served at (data 2, model 1), each rank its
rows.
"""
import concurrent.futures

import numpy as np
import pytest

import torch_serve_tp as S
import torch_spmd

TOL = 1e-5
FAMILIES = ("gemma3-1b", "qwen2-vl-7b", "qwen3-moe-30b-a3b",
            "mixtral-8x7b/e3", "rwkv6-3b")
OTHERS = ("recurrentgemma-2b", "whisper-small")
B, P = 4, 60
M12 = ((1, 2), ("data", "model"))
M22 = ((2, 2), ("data", "model"))
M21 = ((2, 1), ("data", "model"))

ONE = ([(f"one/{c}", None, None, c, B, P) for c in FAMILIES + OTHERS]
       + [("one/b1", None, None, "gemma3-1b", 1, 68),
          ("one/ragged", None, None, "gemma3-1b", B, 61)])
TWO = ([(f"m12/{c}", *M12, c, B, P) for c in FAMILIES]
       + [("m12/ragged", *M12, "gemma3-1b", B, 61)]
       + [(f"m12/{c}", *M12, c, B, P) for c in OTHERS]
       + [(f"m21/{c}", *M21, c, B, P) for c in ("gemma3-1b", "rwkv6-3b")
          + OTHERS])
FOUR = ([(f"m22/{c}", *M22, c, B, P) for c in FAMILIES]
        + [("m22/b1", *M22, "gemma3-1b", 1, 68)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_worlds")
    params = {c: S.full_params(c) for c in FAMILIES + OTHERS}
    jobs = {"one": (1, ONE), "two": (2, TWO), "four": (4, FOUR)}
    for name in jobs:
        (tmp / name).mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(torch_spmd.run_world, S.world_cases, n,
                                tmp / name, cases, params)
                for name, (n, cases) in jobs.items()}
        return {name: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                for name, f in futs.items()}


def _close(got, want, what):
    scale = np.abs(want).max()
    gap = np.abs(got - want).max()
    assert gap <= TOL * scale, f"{what}: {gap:.3g} > {TOL} * {scale:.3g}"


def _against_one(ranks, one, name):
    for r in ranks:
        lo, n = r["rows"]
        rows = slice(lo, lo + n)
        _close(r["prefill"], one["prefill"][rows], f"{name} prefill")
        for k, v in r["caches"].items():       # batch second in every leaf
            _close(v, one["caches"][k][:, rows], f"{name} cache {k}")
        _close(r["decode"], one["decode"][:, rows], f"{name} decode")
        np.testing.assert_array_equal(r["ids"], one["ids"][rows])


CASES = [(w, c) for w in ("m12", "m22") for c in FAMILIES]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c.replace('/', '_')}" for w, c in CASES])
def test_serve_step_matches_world_of_one(worlds, world, case):
    ranks = worlds["two" if world == "m12" else "four"]
    _against_one([r[f"{world}/{case}"] for r in ranks],
                 worlds["one"][0][f"one/{case}"], f"{world}/{case}")


def test_gemma_local_window_crosses_and_empties_a_slice(worlds):
    """At (1, 2) the cache of 64 rows is 32 a rank; decode positions 60..63
    with window 32 start at rows 29..32: rank 0 holds part of the first
    window and none of the last."""
    ranks = [r["m12/gemma3-1b"] for r in worlds["two"]]
    assert [r["kv"] for r in ranks] == [(0, 32, 2), (32, 32, 2)]
    assert P - 32 + 1 < 32 <= P + 3 - 32 + 1


def test_batch_of_one_shards_cache_over_data_and_model(worlds):
    ranks = [r["m22/b1"] for r in worlds["four"]]
    assert [r["kv"] for r in ranks] == [(18 * i, 18, 4) for i in range(4)]
    _against_one(ranks, worlds["one"][0]["one/b1"], "m22/b1")


def test_cache_length_model_does_not_divide_stays_whole(worlds):
    ranks = [r["m12/ragged"] for r in worlds["two"]]
    assert all(r["kv"] is None for r in ranks)
    assert all(r["state"]["k"].shape[2] == 65 for r in ranks)
    _against_one(ranks, worlds["one"][0]["one/ragged"], "m12/ragged")


@pytest.mark.parametrize("case", OTHERS)
def test_rglru_and_whisper_raise_at_model_two(worlds, case):
    """rglru and whisper on a "model" axis of 2 (which once raised): the
    recurrent block on its LRU columns, the heads, the decode caches' rows
    over "model", each rank's rows equal to the world of one's."""
    ranks = [r[f"m12/{case}"] for r in worlds["two"]]
    assert [r["kv"] for r in ranks] == [(0, 32, 2), (32, 32, 2)]
    _against_one(ranks, worlds["one"][0][f"one/{case}"], f"m12/{case}")


@pytest.mark.parametrize("case", ("gemma3-1b", "rwkv6-3b") + OTHERS)
def test_every_family_serves_its_rows_at_data_two(worlds, case):
    ranks = [r[f"m21/{case}"] for r in worlds["two"]]
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 2)]
    _against_one(ranks, worlds["one"][0][f"one/{case}"], f"m21/{case}")
