"""The port's sharded serving step (``build_serve_step``) across the zoo:
the rules' head_dim fallback and recurrentgemma and whisper over "model",
on gloo worlds of 2 and 8 ranks on the CPU (``tests/torch_spmd.py::
run_world``; the ranks run ``tests/torch_serve_tp.py``), all at once.

  * (data 1, model 2): 3-head variants (``torch_train_tp.config``: 3 heads
    on 2 fall back to head_dim) of gemma3-1b, qwen2-vl, qwen3-moe, rwkv6
    (K6 on a rank's value columns; its decode state's ``wkv`` whole),
    recurrentgemma (the fallback in its local attention and its LRU
    columns) and whisper (self and cross caches over "model");
  * (1, 8): the smoke configs of gemma3-1b, rwkv6 and recurrentgemma (4
    heads on 8);
parameters in float32: prefill's last-64 logits and caches, then 4 greedy
decode steps, each rank's rows within 1e-5 of their scale of the world of
one's, the ids equal; and each rank's parameters and decode state of the
shapes the reference's rules give (``_rules_with_zero`` in decode mode,
``logical_spec``, ``_state_spec`` of the JAX package).
"""
import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest

import repro.sharding as jsh
from repro.configs import get_config as j_get_config
from repro.launch.steps import _rules_with_zero, _state_spec
from repro.models import get_model as j_get_model

import torch_serve_tp as S
import torch_spmd

TOL = 1e-5
B, P = 4, 60
M12 = ((1, 2), ("data", "model"))
M18 = ((1, 8), ("data", "model"))
H3 = ("gemma3-1b/h3", "qwen2-vl-7b/h3", "qwen3-moe-30b-a3b/h3", "rwkv6-3b/h3",
      "recurrentgemma-2b/h3", "whisper-small/h3")
SMOKE = ("gemma3-1b", "rwkv6-3b", "recurrentgemma-2b")
ALL = sorted(set(H3 + SMOKE))

ONE = [(f"one/{c}", None, None, c, B, P) for c in ALL]
TWO = [(f"m12/{c}", *M12, c, B, P) for c in H3]
EIGHT = [(f"m18/{c}", *M18, c, B, P) for c in SMOKE]
CASES = ([("m12", c, "two") for c in H3]
         + [("m18", c, "eight") for c in SMOKE])
IDS = [f"{w}-{c.replace('/', '_')}" for w, c, _ in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_zoo")
    params = {c: S.full_params(c) for c in ALL}
    jobs = {"one": (1, ONE), "two": (2, TWO), "eight": (8, EIGHT)}
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


@pytest.mark.parametrize("world,case,job", CASES, ids=IDS)
def test_serve_step_matches_world_of_one(worlds, world, case, job):
    one = worlds["one"][0][f"one/{case}"]
    for r in worlds[job]:
        got = r[f"{world}/{case}"]
        lo, n = got["rows"]
        rows = slice(lo, lo + n)
        _close(got["prefill"], one["prefill"][rows], "prefill")
        for k, v in got["caches"].items():     # batch second in every leaf
            _close(v, one["caches"][k][:, rows], f"cache {k}")
        _close(got["decode"], one["decode"][:, rows], "decode")
        np.testing.assert_array_equal(got["ids"], one["ids"][rows])
        for k, v in got["state"].items():
            _close(v, one["state"][k][:, rows], f"state {k}")


def _j_config(case: str):
    arch, _, variant = case.partition("/")
    cfg = j_get_config(arch).smoke_config()
    if variant == "h3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
        if cfg.family == "rwkv6":
            cfg = dataclasses.replace(cfg, d_model=3 * cfg.d_head)
    return cfg


def _local(shape, spec, mesh_shape) -> tuple:
    out = []
    for n, phys in zip(shape, spec):
        for a in (phys if isinstance(phys, tuple) else (phys,)):
            n //= mesh_shape[a] if a is not None else 1
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("world,case,job", CASES, ids=IDS)
def test_rank_shapes_are_the_reference_rules_slices(worlds, world, case,
                                                    job):
    """Every parameter (the decode rules' weights, as prefill's) and every
    decode-state leaf of each rank has the shape of its slice under the
    reference's rules; under the fallback a K/V or wkv state stays whole
    along its heads and head_dim."""
    shape, names = {"m12": M12, "m18": M18}[world]
    mesh_shape = dict(zip(names, shape))
    batch = B
    cfg = _j_config(case)
    jmesh = types.SimpleNamespace(shape=mesh_shape)
    rules = _rules_with_zero(cfg, jmesh, "decode", decode_batch=batch)
    schema = j_get_model(cfg).schema
    for r in worlds[job]:
        got = r[f"{world}/{case}"]["shapes"]
        with jsh.use_sharding(jmesh, rules):
            for k, ps in schema.items():
                want = _local(ps.shape, jsh.logical_spec(ps.axes, ps.shape),
                              mesh_shape)
                assert got["params"][k] == want, (k, got["params"][k], want)
            whole = r[f"{world}/{case}"]["state"]
            for k, loc in got["state"].items():
                full = list(whole[k].shape)
                full[1] = batch                # the global batch
                want = _local(full, _state_spec(tuple(full), rules, jmesh),
                              mesh_shape)
                assert loc == want, (k, loc, want)
