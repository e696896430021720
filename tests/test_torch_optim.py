"""The port's optimizer (``repro_torch.optim``) and sharding rules
(``repro_torch.sharding``) against the JAX package's.

Tolerances:
  * ``adamw_update`` on the same float32 master/m/v and gradients: master,
    m, v and the gradient norm within 1e-6 relative (float32 rounding of
    ``pow`` and of sums taken in another order); the bf16 parameters within
    one bf16 ulp (a master weight on a rounding boundary can round either
    way);
  * the schedules: float32, within 1e-6;
  * the rules, the resolved specs and the ZeRO-1 dimensions: equal.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro.sharding as jsh
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro_torch import optim as topt
from repro_torch import sharding as tsh
from repro_torch.configs import get_config
from repro_torch.models.model_api import schema_for

ADAM_RTOL = 1e-6


def _state(seed, shapes):
    rng = np.random.default_rng(seed)
    f = lambda s: rng.normal(size=s).astype(np.float32)
    params = {k: f(s) for k, s in shapes.items()}
    grads = {k: f(s) * 0.3 for k, s in shapes.items()}
    st = {"master": params,
          "m": {k: f(s) * 0.01 for k, s in shapes.items()},
          "v": {k: np.abs(f(s)) * 1e-4 for k, s in shapes.items()},
          "step": np.asarray(4, np.int32)}
    return params, grads, st


def _close(a, b, rtol=ADAM_RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("grad_scale", [0.01, 30.0], ids=["unclipped",
                                                         "clipped"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_adamw_update_matches_reference(grad_scale, lr_scale):
    shapes = {"a/w": (16, 24), "b": (40,), "c/stack": (3, 8, 5)}
    params, grads, st = _state(0, shapes)
    grads = {k: g * grad_scale for k, g in grads.items()}
    cfg_j = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    cfg_t = topt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jst = {"master": {k: jnp.asarray(v) for k, v in st["master"].items()},
           "m": {k: jnp.asarray(v) for k, v in st["m"].items()},
           "v": {k: jnp.asarray(v) for k, v in st["v"].items()},
           "step": jnp.asarray(st["step"])}
    jnp_, jst2, jm = jopt.adamw_update(
        jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst, cfg_j,
        lr_scale=lr_scale)
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in t(params).items()}
    tst = {"master": t(st["master"]), "m": t(st["m"]), "v": t(st["v"]),
           "step": torch.tensor(4, dtype=torch.int32)}
    tnp, tst2, tm = topt.adamw_update(tp, t(grads), tst, cfg_t,
                                      lr_scale=lr_scale)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    _close(float(tm["clip"]), float(jm["clip"]))
    assert (float(jm["clip"]) < 1.0) == (grad_scale > 1)
    assert int(tst2["step"]) == int(jst2["step"]) == 5
    for k in shapes:
        for key in ("master", "m", "v"):
            _close(tst2[key][k].numpy(), np.asarray(jst2[key][k]))
        got = tnp[k].float().numpy()
        want = np.asarray(jnp_[k].astype(jnp.float32))
        assert tnp[k].dtype == torch.bfloat16
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - want) <= ulp), k


def test_adamw_slices_with_a_global_norm_equal_the_whole_update():
    """The ZeRO-1 form: slices of leaves updated with the whole gradients'
    squared norms give the slices of the whole update, bit for bit."""
    shapes = {"a": (8, 6), "b": (10,)}
    params, grads, st = _state(1, shapes)
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    cfg = topt.AdamWConfig(lr=1e-3)
    tst = {"master": t(st["master"]), "m": t(st["m"]), "v": t(st["v"]),
           "step": torch.tensor(4, dtype=torch.int32)}
    tp = {k: v.to(torch.bfloat16) for k, v in t(params).items()}
    whole_p, whole_s, whole_m = topt.adamw_update(tp, t(grads), tst, cfg)
    norm_sq = topt.global_norm_sq(t(grads))
    sl = {"a": lambda x: x[4:], "b": lambda x: x}
    part = lambda d: {k: sl[k](v) for k, v in d.items()}
    sp, ss, sm = topt.adamw_update(
        part(tp), part(t(grads)),
        {"master": part(tst["master"]), "m": part(tst["m"]),
         "v": part(tst["v"]), "step": tst["step"]}, cfg, norm_sq=norm_sq)
    assert torch.equal(sm["grad_norm"], whole_m["grad_norm"])
    for k in shapes:
        assert torch.equal(sp[k], sl[k](whole_p[k]))
        assert torch.equal(ss["master"][k], sl[k](whole_s["master"][k]))


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    js, ts = jnp.asarray(step, jnp.int32), torch.tensor(step)
    np.testing.assert_allclose(
        float(topt.cosine_schedule(ts, 100)),
        float(jopt.cosine_schedule(js, 100)), rtol=1e-6)
    np.testing.assert_allclose(
        float(topt.linear_warmup_cosine(ts, 10, 100, 0.05)),
        float(jopt.linear_warmup_cosine(js, 10, 100, 0.05)), rtol=1e-6,
        atol=1e-7)


def test_adamw_init_matches_reference_layout():
    p = {"w": torch.randn(4, 3).to(torch.bfloat16)}
    st = topt.adamw_init(p)
    assert st["master"]["w"].dtype == torch.float32
    assert torch.equal(st["master"]["w"], p["w"].float())
    assert not st["m"]["w"].any() and not st["v"]["w"].any()
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert set(st) == set(jopt.adamw_init({"w": jnp.zeros((4, 3))}))


MESHES = [{"data": d, "model": m} for d in (1, 2, 4, 16) for m in (1, 16)] \
    + [{"pod": 2, "data": d, "model": 1} for d in (1, 2, 4, 16)]
# ... and (mesh, strategy) pairs with a "model" axis of 2 and 16: 'fsdp'
# puts "model" into ZeRO-1's "zero" axes (the reference's _rules_with_zero)
MESH_STRATEGIES = [(m, "tp") for m in MESHES] + [
    ({"data": 1, "model": 2}, "tp"), ({"data": 2, "model": 2}, "tp"),
    ({"pod": 2, "data": 2, "model": 2}, "tp"),
    ({"data": 1, "model": 2}, "fsdp"), ({"data": 2, "model": 2}, "fsdp"),
    ({"pod": 2, "data": 2, "model": 2}, "fsdp"),
    ({"data": 1, "model": 16}, "fsdp"), ({"data": 16, "model": 16}, "fsdp")]
# every config the "model" axis covers (dense, qwen2-vl, MoE, rwkv6)
TP_ARCHS = ["gemma3-1b", "granite-3-8b", "yi-34b", "glm4-9b", "qwen2-vl-7b",
            "qwen3-moe-30b-a3b", "mixtral-8x7b", "rwkv6-3b"]


def _mesh_id(pair) -> str:
    mesh, strategy = pair
    name = "x".join(f"{k}{v}" for k, v in mesh.items())
    return name if strategy == "tp" else f"{name}-{strategy}"


def _model_axis(phys) -> bool:
    return "model" in (phys if isinstance(phys, tuple) else (phys,))


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("mesh_shape,strategy", MESH_STRATEGIES,
                         ids=[_mesh_id(p) for p in MESH_STRATEGIES])
def test_opt_state_specs_zero_dims_match_reference(arch, mesh_shape,
                                                   strategy):
    """The ZeRO-1 dimension of every parameter's optimizer state, the rules
    behind it and each parameter's "model" dimension are the reference's
    (its ``opt_state_specs`` and ``logical_spec`` under ``use_sharding``
    of its ``build_train_step`` rules, ``_rules_with_zero``, on a stand-in
    mesh of the same axis sizes: the functions read ``mesh.shape`` only).
    Where the reference's rules put "model" on a head_dim (its fallback
    where the heads do not divide), so do the port's."""
    from repro.launch.steps import _rules_with_zero
    cfg_j, cfg_t = j_get_config(arch), get_config(arch)
    jmesh = types.SimpleNamespace(shape=dict(mesh_shape))
    schema = j_get_model(cfg_j).schema
    specs = {k: ps.axes for k, ps in schema.items()}
    shapes = {k: ps.shape for k, ps in schema.items()}
    rules_j = _rules_with_zero(cfg_j, jmesh, "train", strategy=strategy)
    with jsh.use_sharding(jmesh, rules_j):
        want = jopt.opt_state_specs(specs, jmesh, shapes)
        want_zero = {k: (axes.index("zero") if "zero" in axes
                         and jsh.logical_spec(axes, shapes[k])[
                             axes.index("zero")] is not None else None)
                     for k, axes in want["master"].items()}
        want_model = {}
        for k, axes in specs.items():
            spec = jsh.logical_spec(axes, shapes[k])
            dims = [i for i, p in enumerate(spec) if _model_axis(p)]
            want_model[k] = dims[0] if dims else None
    rules_t = tsh.make_rules(cfg_t, mesh_shape, "train", strategy=strategy)
    assert rules_t == {k: v for k, v in rules_j.items() if k != "zero"}
    t_schema = schema_for(cfg_t)
    assert {k: ps.axes for k, ps in t_schema.items()} == specs
    got = topt.opt_state_specs(specs, mesh_shape, shapes, rules_t)
    assert got == want
    rules_t["zero"] = rules_j["zero"]
    assert topt.zero_dims(got, shapes, mesh_shape, rules_t) == want_zero
    n = int(np.prod([mesh_shape[a] for a in (rules_j["zero"] or ())]))
    for k, d in topt.zero_dims(got, shapes, mesh_shape, rules_t).items():
        if d is not None:
            assert shapes[k][d] % n == 0
    # the head_dim fallback's leaves too (its "model" dimension a head_dim)
    assert tsh.model_dims(specs, shapes, mesh_shape, rules_t) == want_model
    assert topt.opt_state_specs(specs, mesh_shape, shapes, rules_t,
                                zero1=False)["master"] == specs


@pytest.mark.parametrize("mode,batch", [("train", None), ("prefill", None),
                                        ("decode", 8), ("decode", 1)])
@pytest.mark.parametrize("strategy", ["tp", "tp_sp", "fsdp"])
def test_make_rules_and_logical_spec_match_reference(mode, batch, strategy):
    jmesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    for arch in ("yi-34b", "gemma3-1b", "mixtral-8x7b"):
        cfg_j, cfg_t = j_get_config(arch), get_config(arch)
        rj = jsh.make_rules(cfg_j, jmesh, mode, batch, strategy)
        rt = tsh.make_rules(cfg_t, jmesh.shape, mode, batch, strategy)
        assert rt == rj, arch
        for names, shape in [(("batch", "heads"), (6, 56)),
                             (("batch", "heads"), (6, 54)),
                             (("heads", "kv_heads"), (56, 8)),
                             (("batch", "kv_seq", None), (8, 64, 3))]:
            with jsh.use_sharding(jmesh, rj):
                want = tuple(jsh.logical_spec(names, shape))
            assert tsh.logical_spec(names, shape, jmesh.shape, rt) == want
