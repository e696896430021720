"""Tensor parallelism over "model" across the zoo in the port's LM train
step: the rules' head_dim fallback (the heads do not divide the "model"
axis) and the recurrentgemma and whisper families, on worlds of gloo ranks
on the CPU (spawned processes, one thread each, every join under a
deadline: ``tests/torch_spmd.py::run_world``; the ranks run
``tests/torch_train_tp.py``). The three worlds start at once.

  * (data 1, model 2): 3-head variants of the smoke configs of gemma3-1b
    (one K/V head), qwen2-vl (M-RoPE), qwen3-moe (experts over "model")
    and rwkv6 (d_model of 3 heads: K6 on a rank's value columns), where 3
    heads on 2 fall back to head_dim; recurrentgemma (its LRU columns and
    4 heads over "model") and its 3-head variant; whisper and its 3-head
    variant: 'tp', 'tp_sp' and 'fsdp'; and gemma3-1b with a d_ff of 129
    under 'tp' and 'tp_sp' (the MLP whole on every rank: under 'tp_sp' it
    runs on the rank's rows, its weights' gradients summed over "model");
  * (1, 8): the smoke configs (4 heads on 8: the fallback, 2 columns of a
    head of 16 a rank) of gemma3-1b and rwkv6 (K6 on 2 value columns)
    under 'tp' and recurrentgemma under 'tp_sp';
each from the seed-0 init cast to float32, one step against the world of
one on the same global batch: the loss within 1e-6 relative, every fused
gradient within 1e-5 of its leaf's scale, the gradient norm within 1e-6
relative (``test_torch_train_tp.py``'s limits); the updated whole leaves
bit-identical on every rank; each rank's parameter and AdamW-state bytes
the slices of the reference's rules (``_rules_with_zero``,
``opt_state_specs``, ``logical_spec`` of the JAX package).
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
M8 = ((1, 8), ("data", "model"))
H3 = ("gemma3-1b/h3", "qwen2-vl-7b/h3", "qwen3-moe-30b-a3b/h3", "rwkv6-3b/h3",
      "recurrentgemma-2b", "recurrentgemma-2b/h3", "whisper-small",
      "whisper-small/h3")
CASES = {"m2": [(c, s) for c in H3 for s in ("tp", "tp_sp", "fsdp")]
         + [("gemma3-1b/ff129", s) for s in ("tp", "tp_sp")],
         "m8": [("gemma3-1b", "tp"), ("rwkv6-3b", "tp"),
                ("recurrentgemma-2b", "tp_sp")]}
LOSS_RTOL, GRAD_TOL, NORM_RTOL = 1e-6, 1e-5, 1e-6


def _microbatches(world: str, strategy: str) -> int:
    """The batch shards of a case: the world of one's microbatches."""
    return 2 if strategy == "fsdp" else 1


PARAMS = [(w, c, s) for w in ("m2", "m8") for c, s in CASES[w]]
IDS = [f"{w}-{c.replace('/', '_')}-{s}" for w, c, s in PARAMS]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_zoo")
    one_runs = sorted({(c, _microbatches(w, s)) for w, c, s in PARAMS})
    jobs = {"m2": (T.tp_cases, 2, tmp / "m2", *M2, CASES["m2"]),
            "m8": (T.tp_cases, 8, tmp / "m8", *M8, CASES["m8"]),
            "one": (T.one_cases, 1, tmp / "one", one_runs)}
    for _, _, path, *_ in jobs.values():
        path.mkdir()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(torch_spmd.run_world, fn, world, path, *args)
                for name, (fn, world, path, *args) in jobs.items()}
        return {name: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
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
    p0 = ranks[0]["cases"][(case, strategy)]["params"]
    for r in ranks[1:]:
        for k, v in r["cases"][(case, strategy)]["params"].items():
            np.testing.assert_array_equal(v, p0[k])


def _reference_bytes(case: str, strategy: str, mesh_shape: dict) -> dict:
    """A rank's float32 parameter and AdamW-state bytes under the JAX
    package's rules (on a stand-in mesh: they read ``mesh.shape`` only)."""
    arch, _, variant = case.partition("/")
    cfg = j_get_config(arch).smoke_config()
    if variant == "h3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
        if cfg.family == "rwkv6":
            cfg = dataclasses.replace(cfg, d_model=3 * cfg.d_head)
    elif variant == "ff129":
        cfg = dataclasses.replace(cfg, d_ff=129)
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
        fallback = any(rules["head_dim"] is not None and "head_dim" in a
                       for a in axes.values())
        return {"params": sum(share(axes[k], shapes[k]) for k in axes),
                "opt": 3 * sum(share(opt[k], shapes[k]) for k in axes),
                "fallback": fallback}


@pytest.mark.parametrize("world,case,strategy", PARAMS, ids=IDS)
def test_rank_bytes_are_the_rules_slices(worlds, world, case, strategy):
    shape, names = M2 if world == "m2" else M8
    want = _reference_bytes(case, strategy, dict(zip(names, shape)))
    # the cases reach the fallback where they were chosen to: 3 heads on
    # 2, 4 on 8, and no weight over "model" but the vocab under 'fsdp'
    assert want.pop("fallback") == (strategy != "fsdp" and (
        world == "m8" or case.endswith("/h3")))
    whole = worlds["one"][0][(case, _microbatches(world, strategy))]["bytes"]
    for r in worlds[world]:
        got = r["cases"][(case, strategy)]["bytes"]
        assert got == want, (got, want)
        assert got["params"] < whole["params"]
