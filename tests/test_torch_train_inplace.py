"""The donated (in-place) train step (``TrainStep(..., donate=True)`` over
``optim/adamw.py::adamw_update_``) on a world of one, on the CPU:

  * three donated steps give the functional steps' bits: parameters,
    master, m, v, the step count and the metrics; also when every leaf is
    updated in pieces of a few rows (``PIECE`` made small), and for the
    families whose forward differs most (dense, MoE, rwkv6);
  * a step whose loss or gradient norm is not finite leaves every tensor
    it was given as it was, bit for bit (NaN and inf included);
  * ``adamw_update_`` alone equals ``adamw_update`` bit for bit on slices
    (ZeRO-1 views that are not contiguous).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import TrainStepConfig, build_train_step
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod

from torch_train import _bits, zoo_aux

SEQ, BATCH = 32, 4


def _setup(arch, mb=2):
    cfg = get_config(arch).smoke_config()
    mesh = make_host_mesh(model=1, device="cpu")
    step = build_train_step(cfg, mesh, ShapeSpec("t", SEQ, BATCH, "train"),
                            TrainStepConfig(microbatches=mb, moe_groups=2))
    data = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=0)
    return step, data, mesh, zoo_aux(cfg, BATCH)


def _snapshot(params, opt):
    out = {("p", k): _bits(v) for k, v in params.items()}
    for key in ("master", "m", "v"):
        out.update({(key, k): _bits(v) for k, v in opt[key].items()})
    out[("step",)] = _bits(opt["step"])
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


@pytest.mark.parametrize("arch,piece", [("granite-3-8b", None),
                                        ("granite-3-8b", 1000),
                                        ("qwen3-moe-30b-a3b", None),
                                        ("rwkv6-3b", 1000)])
def test_donated_steps_equal_functional_steps(arch, piece, monkeypatch):
    if piece is not None:
        monkeypatch.setattr(adamw_mod, "PIECE", piece)
    step, data, mesh, aux = _setup(arch)
    p_f = step.init_params(0)
    o_f = step.init_opt_state(p_f)
    p_d = {k: v.clone() for k, v in p_f.items()}
    o_d = step.init_opt_state(p_d)
    for i in range(3):
        tok, lab = data.global_arrays(i, mesh)
        p_f, o_f, m_f = step(p_f, o_f, tok, lab, aux)
        ids = {k: id(v) for k, v in p_d.items()}
        p_out, o_out, m_d = step(p_d, o_d, tok, lab, aux, donate=True)
        assert p_out is p_d and o_out is o_d
        assert {k: id(v) for k, v in p_d.items()} == ids   # same storage
        for key in ("loss", "grad_norm", "clip", "quant_noise"):
            assert torch.equal(m_f[key], m_d[key]), key
    _same(_snapshot(p_f, o_f), _snapshot(p_d, o_d))
    assert int(o_d["step"]) == 3


@pytest.mark.parametrize("bad", ["loss", "grad_inf", "grad_nan"])
def test_nonfinite_step_leaves_every_tensor(bad, monkeypatch):
    step, data, mesh, aux = _setup("granite-3-8b")
    params = step.init_params(0)
    opt = step.init_opt_state(params)
    tok, lab = data.global_arrays(0, mesh)
    step(params, opt, tok, lab, aux, donate=True)      # a real step first
    before = _snapshot(params, opt)
    grads_fn = step._grads

    def poisoned(*a):
        loss, grads = grads_fn(*a)
        if bad == "loss":
            return loss * float("nan"), grads
        k = sorted(grads)[1]
        grads[k].view(-1)[3] = float("inf" if bad == "grad_inf" else "nan")
        return loss, grads
    monkeypatch.setattr(step, "_grads", poisoned)
    tok, lab = data.global_arrays(1, mesh)
    _, _, m = step(params, opt, tok, lab, aux, donate=True)
    assert not (np.isfinite(float(m["loss"]))
                and np.isfinite(float(m["grad_norm"])))
    _same(before, _snapshot(params, opt))
    monkeypatch.setattr(step, "_grads", grads_fn)
    _, _, m = step(params, opt, tok, lab, aux, donate=True)
    assert np.isfinite(float(m["loss"])) and int(opt["step"]) == 2


def test_in_place_update_on_noncontiguous_slices(monkeypatch):
    """ZeRO-1 hands the update column slices (views, not contiguous)."""
    monkeypatch.setattr(adamw_mod, "PIECE", 64)
    rng = np.random.default_rng(0)
    full = {"a": torch.from_numpy(rng.normal(size=(6, 40)).astype(
        np.float32)).to(torch.bfloat16),
            "b": torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(
                np.float32)).to(torch.bfloat16)}
    sl = lambda t: t.narrow(-1, 8, 8)
    params = {k: sl(v) for k, v in full.items()}
    grads = {k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(
        np.float32)) for k, p in params.items()}
    cfg = AdamWConfig(lr=1e-2)
    st_f = adamw_init({k: v.clone() for k, v in params.items()})
    st_d = adamw_init({k: v.clone() for k, v in params.items()})
    for _ in range(2):
        p_f, st_f, m_f = adamw_update(params, grads, st_f, cfg)
        m_d = adamw_mod.adamw_update_(params, grads, st_d, cfg)
        for k in params:
            assert not params[k].is_contiguous()
            assert torch.equal(params[k], p_f[k]), k
            for key in ("master", "m", "v"):
                assert torch.equal(st_d[key][k], st_f[key][k]), (key, k)
        assert torch.equal(m_d["grad_norm"], m_f["grad_norm"])
    # outside the slices nothing moved
    assert torch.equal(full["a"][:, :8], torch.from_numpy(
        np.random.default_rng(0).normal(size=(6, 40)).astype(np.float32)
    ).to(torch.bfloat16)[:, :8])
