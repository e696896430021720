"""MoE with whole experts under 'tp_sp' (``transformer.moe_whole_tp``):
qwen3-moe's smoke config with 3 experts of a d_ff of 129, neither of which
"model" = 2 divides, so every rank holds every expert whole. The rank's
rows of the residual are gathered and the layer runs on the whole token
set, as the reference's GSPMD runs ``moe_mlp`` whatever the residual's
sharding, so the routing groups and the capacity drops are the world of
one's.

One step at (data=1, model=2) on gloo ranks (``tests/torch_spmd.py``; the
ranks run ``tests/torch_train_tp.py::moe_whole_cases``) against the world
of one, parameters cast to float32, the LM head fed the float32 hidden
state: the loss within 1e-6 relative, every leaf's fused gradient (the
router's and the experts' among them) within 1e-5 of its largest
magnitude (the same float32 products summed in another order), every
dispatch's kept slots equal. At the smoke config's capacity factor of 1.25
no slot is dropped; at 1.0 ("whole_cf1") slots are, and they must be the
same ones.
"""
import concurrent.futures

import numpy as np
import pytest

import torch_spmd
import torch_train_tp as T

LOSS_RTOL, GRAD_TOL, NORM_RTOL = 1e-6, 1e-5, 1e-6


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_whole")
    jobs = {"two": (2, tmp / "two", (1, 2), ("data", "model"), "tp_sp"),
            "one": (1, tmp / "one", (), (), "tp")}
    for _, path, *_ in jobs.values():
        path.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(torch_spmd.run_world, T.moe_whole_cases,
                                world, path, *args)
                for name, (world, path, *args) in jobs.items()}
        return {name: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                for name, f in futs.items()}


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("case", T.MOE_WHOLE)
def test_whole_experts_tp_sp_match_world_of_one(worlds, case):
    one = worlds["one"][0][case]
    for r in worlds["two"]:
        got = r[case]
        assert _rel(got["loss"], one["loss"]) <= LOSS_RTOL, \
            (got["loss"], one["loss"])
        assert _rel(got["grad_norm"], one["grad_norm"]) <= NORM_RTOL
        assert got["moved"]
        assert got["replicas_identical"]
        assert set(got["grads"]) == set(one["grads"])
        for k, want in one["grads"].items():
            scale = np.abs(want).max()
            gap = np.abs(got["grads"][k] - want).max()
            assert gap <= GRAD_TOL * scale, (k, gap / scale)
        for k in ("layers/router", "layers/we_gate", "layers/we_up",
                  "layers/we_down"):
            assert np.abs(got["grads"][k]).max() > 0, k


@pytest.mark.parametrize("case", T.MOE_WHOLE)
def test_whole_experts_tp_sp_drop_the_same_slots(worlds, case):
    want = worlds["one"][0][case]["keeps"]
    assert want
    dropped = sum(int((~k).sum()) for k in want)
    assert (dropped > 0) == case.endswith("cf1"), dropped
    for r in worlds["two"]:
        got = r[case]["keeps"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
