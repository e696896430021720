"""Tensor parallelism over "model" in the port's LM train step
(``tensor_parallel.py``, ``launch/steps.py``) on worlds of gloo ranks:
spawned processes on the CPU, one thread each, every join under a deadline
(``tests/torch_spmd.py::run_world``; the ranks run
``tests/torch_train_tp.py``). Every world starts at once.

  * 'tp' and 'tp_sp' at (data=1, model=2) and (pod=2, data=2, model=2),
    'fsdp' at (data=1, model=2), for the smoke configs of granite-3-8b,
    gemma3-1b (one KV head: each local q head must meet it, the GQA
    mapping by global head index), qwen3-moe (experts over "model"),
    qwen2-vl (M-RoPE, vision embeddings) and rwkv6 (heads over "model", the
    decay and mix LoRAs whole), and mixtral with 3 experts (each expert's
    d_ff over "model"), parameters cast to float32: one step against the
    world of one on the same global batch (its microbatch i the rows of
    the i-th batch shard). The loss within 1e-6 relative, every leaf's fused
    gradient within 1e-5 of its largest magnitude, the gradient norm within
    1e-6 relative: the same float32 products summed in another order (seen
    at most 3.2e-6 of scale, rwkv6's wk). The LM head takes the float32
    hidden state in both worlds (``float32_head``): its bf16
    rounding, and its backward's of the gradient, flip with the summation
    order (bf16 runs are the card's, ``chip_smoke.py``'s ``train_tp``);
  * the updated parameters whole on every "model" rank bit for bit where
    the rules keep them whole, and under 'tp' the final hidden state too;
  * each rank's parameter and optimizer-state bytes are the slices the
    reference's rules give (``_rules_with_zero``, ``opt_state_specs`` and
    ``logical_spec`` of the JAX package);
  * the intent of the reference's two red tests on their mesh (2, 2, 2):
    over 12 steps at lr 2e-3 the exact and int8-over-"pod" losses both
    drop by at least 0.3 and end within 0.5 (its bounds), int8 payloads
    over "pod";
  * a model = 2 Trainer preempted and resumed from its checkpoint gives
    the uninterrupted losses bit for bit; its checkpoint holds whole
    leaves and loads at model = 1 to the same bits.
"""
import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest

import repro.sharding as jsh
from repro.configs import get_config as j_get_config
from repro.launch.steps import _rules_with_zero
from repro.models import get_model as j_get_model
from repro.optim import opt_state_specs as j_opt_state_specs

import torch_spmd
import torch_train_tp as T

M2 = ((1, 2), ("data", "model"))
M8 = ((2, 2, 2), ("pod", "data", "model"))
CASES = {"m2": [(c, s) for c in T.ARCHS + (T.E3,)
                for s in ("tp", "tp_sp", "fsdp")],
         "m8": [(c, s) for c in T.ARCHS for s in ("tp", "tp_sp")]}
LOSS_RTOL, GRAD_TOL, NORM_RTOL = 1e-6, 1e-5, 1e-6
CONVERGE_DROP, CONVERGE_GAP = 0.3, 0.5


def _microbatches(world: str, strategy: str) -> int:
    """The batch shards of a case: the world of one's microbatches."""
    if world == "m8":
        return 4
    return 2 if strategy == "fsdp" else 1


PARAMS = [(w, c, s) for w in ("m2", "m8") for c, s in CASES[w]]
IDS = [f"{w}-{c.replace('/', '_')}-{s}" for w, c, s in PARAMS]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_worlds")
    one_runs = sorted({(c, _microbatches(w, s)) for w, c, s in PARAMS})
    jobs = {
        "m2": (T.tp_cases, 2, tmp / "m2", *M2, CASES["m2"]),
        "m8": (T.tp_cases, 8, tmp / "m8", *M8, CASES["m8"]),
        "one": (T.one_cases, 1, tmp / "one", one_runs),
    }
    for _, _, path, *_ in jobs.values():
        path.mkdir()
    ck = tmp / "ckpt"
    for path in (ck, ck / "w2", ck / "w1"):
        path.mkdir()

    def checkpoints():
        two = torch_spmd.run_world(T.ckpt_cases, 2, ck / "w2", str(ck))
        return two, torch_spmd.run_world(T.ckpt_one, 1, ck / "w1", str(ck))

    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as ex:
        futs = {name: ex.submit(torch_spmd.run_world, fn, world, path, *args)
                for name, (fn, world, path, *args) in jobs.items()}
        futs["ckpt"] = ex.submit(checkpoints)
        return {name: f.result(timeout=2 * torch_spmd.TIMEOUT_S + 30)
                for name, f in futs.items()}


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("world,case,strategy", PARAMS, ids=IDS)
def test_step_matches_world_of_one(worlds, world, case, strategy):
    one = worlds["one"][0][(case, _microbatches(world, strategy))]
    for r in worlds[world]:
        got = r["cases"][(case, strategy)]
        assert _rel(got["loss"], one["loss"]) <= LOSS_RTOL, \
            (got["loss"], one["loss"])
        assert _rel(got["grad_norm"], one["grad_norm"]) <= NORM_RTOL
        assert got["moved"]
        for k, want in one["grads"].items():
            scale = np.abs(want).max()
            gap = np.abs(got["grads"][k] - want).max()
            assert gap <= GRAD_TOL * scale, (k, gap / scale)


@pytest.mark.parametrize("world,case,strategy", PARAMS, ids=IDS)
def test_replicas_bit_identical_across_model_ranks(worlds, world, case,
                                                   strategy):
    ranks = worlds[world]
    for r in ranks:
        got = r["cases"][(case, strategy)]
        assert got["replicas_identical"]
        if strategy == "tp":
            assert got["hidden_identical"]
    # the data ranks agree too: every rank ends with the same whole leaves
    p0 = ranks[0]["cases"][(case, strategy)]["params"]
    for r in ranks[1:]:
        for k, v in r["cases"][(case, strategy)]["params"].items():
            np.testing.assert_array_equal(v, p0[k])


def _reference_bytes(case: str, strategy: str, mesh_shape: dict) -> dict:
    """A rank's float32 parameter and AdamW-state bytes under the JAX
    package's rules (on a stand-in mesh: they read ``mesh.shape`` only)."""
    arch, _, variant = case.partition("/")
    cfg = j_get_config(arch).smoke_config()
    if variant == "e3":
        cfg = dataclasses.replace(cfg, n_experts=3)
    jmesh = types.SimpleNamespace(shape=dict(mesh_shape))
    rules = _rules_with_zero(cfg, jmesh, "train", strategy=strategy)
    schema = j_get_model(cfg).schema
    axes = {k: ps.axes for k, ps in schema.items()}
    shapes = {k: ps.shape for k, ps in schema.items()}

    def share(names, shape):
        n = 1
        for phys in jsh.logical_spec(names, shape):
            for a in (phys if isinstance(phys, tuple) else (phys,)):
                n *= mesh_shape[a] if a is not None else 1
        return int(np.prod(shape)) // n * 4

    with jsh.use_sharding(jmesh, rules):
        opt = j_opt_state_specs(axes, jmesh, shapes)["master"]
        return {"params": sum(share(axes[k], shapes[k]) for k in axes),
                "opt": 3 * sum(share(opt[k], shapes[k]) for k in axes)}


@pytest.mark.parametrize("world,case,strategy", PARAMS, ids=IDS)
def test_rank_bytes_are_the_rules_slices(worlds, world, case, strategy):
    shape, names = M2 if world == "m2" else M8
    want = _reference_bytes(case, strategy, dict(zip(names, shape)))
    whole = worlds["one"][0][(case, _microbatches(world, strategy))]["bytes"]
    for r in worlds[world]:
        got = r["cases"][(case, strategy)]["bytes"]
        assert got == want, (got, want)
        assert got["params"] < whole["params"]


def test_reference_reds_intent_on_their_mesh(worlds):
    """tests/test_solver_distributed.py:139-142's bounds at (2, 2, 2)."""
    ranks = worlds["m8"]
    for r in ranks:
        exact, int8 = r["converge"][None], r["converge"][8]
        assert exact["losses"] == ranks[0]["converge"][None]["losses"]
        e, q = exact["losses"], int8["losses"]
        assert e[-1] < e[0] - CONVERGE_DROP, e
        assert q[-1] < q[0] - CONVERGE_DROP, q
        assert abs(q[-1] - e[-1]) < CONVERGE_GAP, (e[-1], q[-1])
        assert q != e
        pod = int8["pod"]["bytes"]
        assert set(pod["all_to_all"]) == {"uint8"}, pod
        assert set(pod["all_gather"]) == {"uint8"}, pod
        assert "all_to_all" not in exact["pod"]["bytes"]


def test_checkpoint_resumes_bit_for_bit_at_model_two(worlds):
    two, _ = worlds["ckpt"]
    for r in two:
        assert r["preempted"]
        full = {h["step"]: h for h in r["full"]}
        assert r["resumed"][0]["step"] == T.CKPT_EVERY
        for h in r["resumed"]:
            assert h["loss"] == full[h["step"]]["loss"]
            assert h["grad_norm"] == full[h["step"]]["grad_norm"]
        assert r["restored_step"] == T.CKPT_STEPS


def test_model_two_checkpoint_loads_at_model_one(worlds):
    two, one = worlds["ckpt"]
    assert one[0]["restored_step"] == T.CKPT_STEPS
    for k, v in two[0]["whole"].items():
        np.testing.assert_array_equal(one[0]["whole"][k], v)
    for key, tree in two[0]["opt_whole"].items():
        for k, v in tree.items():
            np.testing.assert_array_equal(one[0]["opt_whole"][key][k], v)
