"""What the PyTorch port may and may not do around its edges: it imports
neither ``jax`` nor the JAX package ``repro``; its default device is the
card and without one it raises; its solve loop asks the host nothing.
"""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core.amp as tamp
import repro_torch.core.denoisers as td
import repro_torch.core.engine as te
import repro_torch.core.mp_amp as tmp
import repro_torch.core.state_evolution as tse
import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config
from repro_torch.models import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    return ["repro_torch"] + sorted(
        info.name for info in pkgutil.walk_packages([PKG],
                                                    prefix="repro_torch."))


def test_port_has_the_expected_modules():
    names = set(_modules())
    for want in ("repro_torch.convert", "repro_torch.core.engine",
                 "repro_torch.core.amp", "repro_torch.core.mp_amp",
                 "repro_torch.core.denoisers", "repro_torch.core.quantize",
                 "repro_torch.core.state_evolution",
                 "repro_torch.core.rate_alloc",
                 "repro_torch.core.rate_distortion",
                 "repro_torch.core.compression",
                 "repro_torch.kernels.build",
                 "repro_torch.kernels.amp_fused.ops",
                 "repro_torch.kernels.amp_fused.ref",
                 "repro_torch.kernels.amp_fused.amp_fused",
                 "repro_torch.kernels.amp_fused.col",
                 "repro_torch.kernels.quantize.ops",
                 "repro_torch.kernels.quantize.ref",
                 "repro_torch.kernels.quantize.quantize",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.gemma3_1b", "repro_torch.configs.rwkv6_3b",
                 "repro_torch.configs.glm4_9b",
                 "repro_torch.configs.granite_3_8b",
                 "repro_torch.configs.yi_34b",
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.models.rwkv6", "repro_torch.models.model_api",
                 "repro_torch.kernels.decode_attn.ops",
                 "repro_torch.kernels.decode_attn.ref",
                 "repro_torch.kernels.decode_attn.decode_attn",
                 "repro_torch.kernels.wkv6.ops",
                 "repro_torch.kernels.wkv6.ref",
                 "repro_torch.kernels.wkv6.wkv6",
                 "repro_torch.launch.serve"):
        assert want in names, want
    for src in ("amp_local.cu", "amp_col.cu", "quantize.cu", "amp_common.cuh",
                "decode_attn.cu", "wkv6.cu"):
        assert os.path.exists(os.path.join(PKG, "csrc", src)), src


def test_importing_the_port_imports_neither_jax_nor_repro():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither ``jax`` nor ``repro`` in ``sys.modules`` (and needs no nvcc,
    no triton and no card to be imported)."""
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("clean")


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_profile.py")]
    for base, _, files in os.walk(PKG):
        paths += [os.path.join(base, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(paths)    # every test worker must collect the same list


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_name_neither_jax_nor_repro(path):
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    with open(path) as fh:
        hit = pat.search(fh.read())
    assert hit is None, f"{path}: {hit.group(0)!r}"


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    """The engine and the frontends default to the card and do not carry
    on on the CPU when there is none."""
    assert te.EngineConfig().device == "cuda"
    assert tmp.MPAMPConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prior = td.BernoulliGauss(0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.AmpEngine(prior, te.EngineConfig(n_proc=2, n_iter=2))
    a = np.zeros((8, 16), np.float32)
    y = np.zeros(8, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamp.amp_solve(y, a, prior, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmp.mp_amp_solve(y, a, prior, tmp.MPAMPConfig(2, 2), [np.inf, np.inf])
    # the LM entry points: get_model and the serve launcher
    cfg = get_config("gemma3-1b").smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "gemma3-1b", "--smoke"])
    # asked for the CPU, they run there
    te.AmpEngine(prior, te.EngineConfig(n_proc=2, n_iter=2, device="cpu"))
    out = tserve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    assert out.tokens.shape == (2, 3)


def _small_problem():
    rng = np.random.default_rng(0)
    n, m = 256, 96
    prob = tse.CSProblem(n=n, m=m, prior=td.BernoulliGauss(0.1))
    s0 = (rng.random(n) < 0.1) * rng.normal(size=n)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)).astype(np.float32)
    return prob, a, y


def _engine(layout, ctrl, prob, p, t):
    """An engine of the layout with a fixed schedule, the layout's BT
    controller, or int8 block transport."""
    if layout == "row":
        cfg = te.EngineConfig(n_proc=p, n_iter=t, device="cpu")
        bt = lambda: te.BTRateControl(prob, p, t, n_s2_grid=4, n_u_grid=7)
    else:
        cfg = te.EngineConfig(n_proc=p, n_iter=t, device="cpu",
                              layout=te.ColumnPartition())
        bt = lambda: te.ColumnBTRateControl(prob, p, t, n_u_grid=16)
    if ctrl == "block8":
        return te.AmpEngine(prob.prior, cfg, te.BlockQuantTransport(8, 32))
    controller = te.FixedSchedule([np.inf, 0.05, 0.02]) if ctrl == "fixed" \
        else bt()
    return te.AmpEngine(prob.prior, cfg, te.EcsqTransport(), controller)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("ctrl", ["fixed", "bt", "block8"])
@pytest.mark.parametrize("batched", [False, True], ids=["solve", "solve_many"])
def test_no_host_sync_inside_the_solve_loop(layout, ctrl, batched,
                                            monkeypatch):
    """Between iteration 0 and T nothing reads a tensor's value on the
    host: ``item``/``tolist``/``__bool__``/``__float__``/``cpu``/``numpy``
    raise while the loop (``_solve_core`` / ``_col_solve_core``) runs (on
    the CPU they would not block, but the same calls on the card would each
    wait for the device). Nor is a Python number written into a tensor: on
    the card that is a copy from the host, which waits too."""
    prob, a, y = _small_problem()
    p, t = 4, 3
    eng = _engine(layout, ctrl, prob, p, t)
    loop = "_solve_core" if layout == "row" else "_col_solve_core"
    inner = getattr(eng, loop)
    calls = []
    setitem = torch.Tensor.__setitem__

    def checked_setitem(self, index, value):
        if isinstance(value, (int, float)):
            raise AssertionError("host sync inside the loop: a Python number "
                                 "written into a tensor")
        return setitem(self, index, value)

    def guarded(*args, **kw):
        def boom(name):
            def raiser(self, *a_, **k_):
                raise AssertionError(f"host sync inside the loop: {name}")
            return raiser
        with monkeypatch.context() as mp:
            for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                         "cpu", "numpy", "__index__"):
                mp.setattr(torch.Tensor, name, boom(name))
            mp.setattr(torch.Tensor, "__setitem__", checked_setitem)
            calls.append(1)
            return inner(*args, **kw)

    monkeypatch.setattr(eng, loop, guarded)
    if batched:
        tr = eng.solve_many(np.stack([y, 1.1 * y]), a)
        assert tr.x.shape == (2, 256)
    else:
        tr = eng.solve(y, a)
        assert tr.x.shape == (256,)
    assert calls == [1] and np.all(np.isfinite(tr.x))


def test_the_guard_itself_catches_a_sync(monkeypatch):
    """The host loop does sync once per iteration, by design — and the same
    patch that guards ``solve`` sees it."""
    prob, a, y = _small_problem()
    eng = te.AmpEngine(prob.prior, te.EngineConfig(n_proc=4, n_iter=2,
                                                   device="cpu"),
                       te.EcsqTransport(), te.FixedSchedule([0.1, 0.1]))

    def raiser(self, *a_, **k_):
        raise AssertionError("host sync")
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "__float__", raiser)
        with pytest.raises(AssertionError, match="host sync"):
            eng.solve_host_loop(y, a)


def test_loop_body_sources_hold_no_sync_calls():
    """Source check on the functions that make up the loop body."""
    import inspect
    fns = [te.AmpEngine._body, te.AmpEngine._local, te.AmpEngine._fuse,
           te.AmpEngine._gc, te.AmpEngine._solve_core, te.AmpEngine._record,
           te.AmpEngine._col_body, te.AmpEngine._col_round,
           te.AmpEngine._col_inner, te.AmpEngine._col_solve_core,
           te.amp_gc_step, te.bt_delta_for, te.interp, te._bt_mmse,
           te._bt_predict_next, te._bt_msg_sd, te._bt_rate_lookup,
           te._bt_cap_sq2, te.col_bt_delta_for,
           te.EcsqTransport.fuse, te.ExactFusion.fuse,
           te.BlockQuantTransport.fuse, te.BTRateControl.delta_for,
           te.ColumnBTRateControl.delta_for]
    pat = re.compile(r"\.item\(|\.cpu\(|\.numpy\(|\.tolist\(|float\(|bool\(")
    for fn in fns:
        src = inspect.getsource(fn)
        hit = pat.search(src)
        assert hit is None, f"{fn.__qualname__}: {hit.group(0)!r}"


def test_version():
    assert isinstance(repro_torch.__version__, str)
