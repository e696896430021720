"""What the PyTorch port may and may not do around its edges: it imports
neither ``jax`` nor the JAX package ``repro``; its default device is the
card and without one it raises; its solve loops, the erasure ones
included, ask the host nothing.
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
import repro_torch.core.collectives as tcoll
import repro_torch.core.compression as tcomp
import repro_torch.launch.amp_serve as tamp_serve
import repro_torch.launch.mesh as tmesh
import repro_torch.launch.serve as tserve
import repro_torch.serving as tserving
import repro_torch.kernels.quantize.ops as tqops
import repro_torch.kernels.quantize.ref as tqref
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
                 "repro_torch.configs.qwen3_moe_30b_a3b",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.configs.qwen2_vl_7b",
                 "repro_torch.configs.whisper_small",
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.models.rwkv6", "repro_torch.models.model_api",
                 "repro_torch.models.moe", "repro_torch.models.rglru",
                 "repro_torch.models.whisper",
                 "repro_torch.kernels.decode_attn.ops",
                 "repro_torch.kernels.decode_attn.ref",
                 "repro_torch.kernels.decode_attn.decode_attn",
                 "repro_torch.kernels.wkv6.ops",
                 "repro_torch.kernels.wkv6.ref",
                 "repro_torch.kernels.wkv6.wkv6",
                 "repro_torch.launch.serve",
                 "repro_torch.core.entropy_code",
                 "repro_torch.telemetry", "repro_torch.telemetry.metrics",
                 "repro_torch.telemetry.spans", "repro_torch.telemetry.drift",
                 "repro_torch.serving", "repro_torch.serving.buckets",
                 "repro_torch.serving.batcher",
                 "repro_torch.serving.operand_cache",
                 "repro_torch.serving.wire", "repro_torch.serving.service",
                 "repro_torch.serving.codec", "repro_torch.serving.router",
                 "repro_torch.serving.frontend", "repro_torch.serving.chaos",
                 "repro_torch.launch.amp_serve",
                 "repro_torch.launch.multihost",
                 "repro_torch.launch.mesh", "repro_torch.launch.solver",
                 "repro_torch.core.collectives",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedules", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.store", "repro_torch.sharding",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.runtime", "repro_torch.runtime.trainer"):
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
    # the solve service and its launcher
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.SolveService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamp_serve.main(["--smoke"])
    assert tserving.SolveService(device="cpu").device.type == "cpu"
    # the mesh: a rank's device is the card unless asked for the CPU, and
    # the mesh launcher raises before it spawns anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.rank_device(None, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.rank_device("cuda:0", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tamp_serve.main(["--smoke", "--mesh", "2"])
    assert tmesh.rank_device("cpu", 3).type == "cpu"
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


def _guard_loop(eng, loop, monkeypatch):
    """Patch ``eng.<loop>`` so that any host read or Python-number write
    into a tensor raises while it runs; returns the list its calls land
    in."""
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
    return calls


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
    calls = _guard_loop(eng, loop, monkeypatch)
    if batched:
        tr = eng.solve_many(np.stack([y, 1.1 * y]), a)
        assert tr.x.shape == (2, 256)
    else:
        tr = eng.solve(y, a)
        assert tr.x.shape == (256,)
    assert calls == [1] and np.all(np.isfinite(tr.x))


def _het_params(t, with_bt, bt, dummy, drop=None):
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return te.HetParams(
        sched=f32([[np.inf, 0.05, 0.02]] * 2),
        t_active=torch.tensor([3, 2]), m_real=f32([96.0, 96.0]),
        n_real=torch.tensor([256, 240]), eps=f32([0.1, 0.05]),
        mu_s=f32([0.0, 0.0]), sigma_s=f32([1.0, 1.0]),
        use_bt=torch.tensor([with_bt, False]),
        bt=te.stack_bt_tables([bt if with_bt else dummy, dummy]), drop=drop)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("with_bt", [False, True], ids=["no_bt", "bt"])
def test_no_host_sync_inside_the_het_loop(layout, with_bt, monkeypatch):
    """``solve_het``'s loop (``_het_core`` / ``_col_het_core``) asks the host
    nothing either: two instances of their own prior, budget and real size,
    one of them BT-rated when ``with_bt``."""
    prob, a, y = _small_problem()
    p, t = 4, 3
    col = layout == "col"
    if col:
        cfg = te.EngineConfig(n_proc=p, n_iter=t, device="cpu",
                              layout=te.ColumnPartition())
        a_b = np.stack([te.split_problem_cols(a, p)] * 2)
        y_b = np.stack([y, 1.1 * y])
        bt = te.ColumnBTRateControl(prob, p, t, n_u_grid=16).tables
        dummy = te.ColBTTables.dummy(t, 16)
        loop = "_col_het_core"
    else:
        cfg = te.EngineConfig(n_proc=p, n_iter=t, device="cpu")
        a_p, y_p = te.split_problem(a, y, p)
        a_b, y_b = np.stack([a_p] * 2), np.stack([y_p, 1.1 * y_p])
        bt = te.BTRateControl(prob, p, t, n_s2_grid=4, n_u_grid=7).tables
        dummy = te.BTTables.dummy(t, 4, 7)
        loop = "_het_core"
    eng = te.AmpEngine(prob.prior, cfg, te.EcsqTransport())
    hp = _het_params(t, with_bt, bt, dummy)
    calls = _guard_loop(eng, loop, monkeypatch)
    tr = eng.solve_het(a_b, y_b, hp, has_bt=with_bt)
    assert calls == [1] and tr.x.shape == (2, 256)
    assert np.all(np.isfinite(tr.x)) and tr.sigma2_hat[1, 2] == 0.0


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("ctrl", ["fixed", "bt", "block8"])
@pytest.mark.parametrize("path", ["solve", "het"])
def test_no_host_sync_inside_the_erasure_loops(layout, ctrl, path,
                                               monkeypatch):
    """The erasure loops ask the host nothing either: a single solve with
    a (T, P) drop mask (the row survivor rescale, the column reset; K4's
    erasure form in the block8 case) and a heterogeneous batch with
    (B, T, P) masks, one instance lossless, its rows taken as views by a
    Python int."""
    prob, a, y = _small_problem()
    p, t = 4, 3
    drop = np.zeros((t, p), np.float32)
    drop[0, 1] = drop[1, 0] = drop[1, 3] = drop[2, :] = 1.0
    eng = _engine(layout, ctrl, prob, p, t)
    col = layout == "col"
    if path == "solve":
        loop = "_col_solve_core" if col else "_solve_core"
        calls = _guard_loop(eng, loop, monkeypatch)
        tr = eng.solve(y, a, drop_sched=drop)
        assert calls == [1] and tr.x.shape == (256,)
        assert np.all(np.isfinite(tr.x))
        return
    if col:
        a_b = np.stack([te.split_problem_cols(a, p)] * 2)
        y_b = np.stack([y, 1.1 * y])
        bt, dummy = (te.ColumnBTRateControl(prob, p, t, n_u_grid=16).tables,
                     te.ColBTTables.dummy(t, 16))
    else:
        a_p, y_p = te.split_problem(a, y, p)
        a_b, y_b = np.stack([a_p] * 2), np.stack([y_p, 1.1 * y_p])
        bt, dummy = (te.BTRateControl(prob, p, t, n_s2_grid=4,
                                      n_u_grid=7).tables,
                     te.BTTables.dummy(t, 4, 7))
    with_bt = ctrl == "bt"
    hp = _het_params(t, with_bt, bt, dummy,
                     drop=torch.from_numpy(np.stack([drop, 0 * drop])))
    calls = _guard_loop(eng, "_col_het_core" if col else "_het_core",
                        monkeypatch)
    tr = eng.solve_het(a_b, y_b, hp, has_bt=with_bt)
    assert calls == [1] and tr.x.shape == (2, 256)
    assert np.all(np.isfinite(tr.x))


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of this process alone (a FileStore under tmp_path), its
    mesh on the CPU; destroyed after the test."""
    import torch.distributed as dist
    tmesh.init_cluster(num_processes=1, process_id=0, backend="gloo",
                       store_path=str(tmp_path / "store"), timeout_s=60)
    try:
        yield tmesh.make_serve_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("transport", ["psum_ecsq", "compressed8",
                                       "compressed4"])
@pytest.mark.parametrize("path", ["solve_sharded", "het"])
def test_no_host_sync_inside_the_sharded_loops(layout, transport, path,
                                               world_of_one, monkeypatch):
    """The sharded loops ask the host nothing either, collectives included
    (``psum`` of the plug-in, the straggler count and the boundary terms,
    ``compressed_psum``'s all-to-all and all-gather, the column gather):
    the same guard, on a gloo world of one rank."""
    prob, a, y = _small_problem()
    p, t = 4, 3
    col = layout == "col"
    tr_ = {"psum_ecsq": te.PsumFusion(local=te.EcsqTransport()),
           "compressed8": te.CompressedPsumTransport(bits=8, block=32),
           "compressed4": te.CompressedPsumTransport(bits=4, block=32)}
    cfg = te.EngineConfig(n_proc=p, n_iter=t, device="cpu",
                          collect_symbols=False,
                          **({"layout": te.ColumnPartition()} if col else {}))
    eng = te.AmpEngine(prob.prior, cfg, tr_[transport],
                       te.FixedSchedule([np.inf, 0.05, 0.02]))
    drop = np.zeros((t, 1), np.float32)
    drop[1, 0] = 1.0
    if path == "solve_sharded":
        calls = _guard_loop(eng, "_col_solve_core" if col else "_solve_core",
                            monkeypatch)
        tr = eng.solve_sharded(y, a, world_of_one, drop_sched=drop)
    else:
        if col:
            a_p, y_p = te.split_problem_cols(a, p), y
            dummy = te.ColBTTables.dummy(t, 16)
        else:
            a_p, y_p = te.split_problem(a, y, p)
            dummy = te.BTTables.dummy(t, 4, 7)
        hp = _het_params(t, False, None, dummy,
                         drop=torch.from_numpy(np.stack([drop, drop])))
        one = lambda v: v[0]
        hp = hp._replace(**{f: one(getattr(hp, f)) for f in (
            "sched", "t_active", "m_real", "n_real", "eps", "mu_s",
            "sigma_s", "use_bt", "drop")},
            bt=type(hp.bt)(*(one(v) for v in hp.bt)))
        calls = _guard_loop(eng, "_col_het_core" if col else "_het_core",
                            monkeypatch)
        tr = eng.solve_sharded_het(a_p, y_p, hp, world_of_one, has_bt=False)
    assert calls == [1] and tr.x.shape == (256,)
    assert np.all(np.isfinite(tr.x))


@pytest.mark.parametrize("case", ["ok", "a_leading", "y_rows", "sched",
                                  "drop", "emulated_transport"])
def test_check_sharded_refuses_malformed_operands(case, world_of_one):
    """``check_sharded`` (what a mesh worker runs before any rank starts a
    solve's collectives) refuses, from the shapes alone, every operand that
    ``dispatch_sharded`` would refuse."""
    prob, a, y = _small_problem()
    p, t = 4, 3
    transport = te.ExactFusion() if case == "emulated_transport" \
        else te.PsumFusion()
    eng = te.AmpEngine(prob.prior, te.EngineConfig(
        n_proc=p, n_iter=t, device="cpu", collect_symbols=False), transport)
    a_p, y_p = te.split_problem(a, y, p)
    hp = _het_params(t, False, None, te.BTTables.dummy(t, 4, 7),
                     drop=torch.zeros(2, t, 1))
    hp = hp._replace(**{f: getattr(hp, f)[0] for f in (
        "sched", "t_active", "m_real", "n_real", "eps", "mu_s", "sigma_s",
        "use_bt", "drop")}, bt=type(hp.bt)(*(v[0] for v in hp.bt)))
    a_shape, y_shape = a_p.shape, y_p.shape
    if case == "a_leading":
        a_shape = (p - 1,) + a_shape[1:]
    elif case == "y_rows":
        y_shape = (p, y_shape[1] + 1)
    elif case == "sched":
        hp = hp._replace(sched=hp.sched[:-1])
    elif case == "drop":
        hp = hp._replace(drop=torch.zeros(t, 2))
    if case == "ok":
        assert eng.check_sharded(a_shape, y_shape, hp, world_of_one) == p
        return
    err = TypeError if case == "emulated_transport" else ValueError
    with pytest.raises(err):
        eng.check_sharded(a_shape, y_shape, hp, world_of_one)
    with pytest.raises(err):
        eng.dispatch_sharded(np.zeros(a_shape, np.float32),
                             np.zeros(y_shape, np.float32), hp, world_of_one,
                             has_bt=False)


def test_device_transports_refuse_the_emulated_entry_points():
    """The reference's guard: a device-collective transport fuses over a
    mesh, so the emulated entry points refuse it."""
    prob, a, y = _small_problem()
    eng = te.AmpEngine(prob.prior, te.EngineConfig(n_proc=4, n_iter=2,
                                                   device="cpu"),
                       te.PsumFusion())
    with pytest.raises(TypeError, match="device-collective"):
        eng.solve(y, a)


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
           te.ColumnBTRateControl.delta_for, tqops.block_quant_fuse,
           tqref.block_quant_fuse_ref, te.AmpEngine._body_het,
           te.AmpEngine._het_core, te.AmpEngine._col_body_het,
           te.AmpEngine._col_het_core, te._search, te._take, te._first,
           te._last, te._erasure_rescale, te._survivors, te._per_proc,
           te._drop_at, te.PsumFusion.fuse, te.CompressedPsumTransport.fuse,
           te._drop_rescale, te.AmpEngine._col_gather_x,
           te.AmpEngine._rank_drops, tcoll.psum, tcoll.pmean,
           tcoll.all_to_all, tcoll.all_gather, tcoll._wire,
           tcomp.compressed_psum, tcomp._wire_encode, tcomp._wire_decode,
           tqops.quantize, tqops.dequantize, tqops.dequantize_sum,
           tqref.dequantize_sum_ref]
    pat = re.compile(r"\.item\(|\.cpu\(|\.numpy\(|\.tolist\(|float\(|bool\(")
    for fn in fns:
        src = inspect.getsource(fn)
        hit = pat.search(src)
        assert hit is None, f"{fn.__qualname__}: {hit.group(0)!r}"


def test_lm_decode_sources_hold_no_sync_calls():
    """Source check on what a decode step of every family runs (the MoE
    dispatch, the M-RoPE tables, the recurrent blocks, Whisper's two
    attentions); ``test_torch_{models,moe,rglru,mrope,whisper}.py`` run
    the decode loops themselves under the runtime guard."""
    import inspect
    from repro_torch.models import layers, moe, rglru, transformer, whisper
    fns = [tserve.decode, transformer.dense_decode_step, transformer._mlp,
           transformer._ropes_for, transformer._qkv, layers.out_proj,
           moe.moe_mlp, moe._dispatch_group, moe.route,
           layers.mrope_positions, layers.mrope_cache, layers.apply_rope,
           layers.rope_cache, rglru.rglru_decode_step, rglru._rec_block,
           rglru._sub_states, rglru._mlp_tail, whisper.whisper_decode_step,
           whisper._gelu_mlp]
    pat = re.compile(r"\.item\(|\.cpu\(|\.numpy\(|\.tolist\("
                     r"|(?<![\w.])(float|bool)\(")
    for fn in fns:
        src = inspect.getsource(fn)
        hit = pat.search(src)
        assert hit is None, f"{fn.__qualname__}: {hit.group(0)!r}"


def test_train_step_sources_hold_no_sync_calls():
    """Source check on what a train step runs (the loss and its chunks, the
    layers' recompute, the fusion, ZeRO-1 and AdamW); the CPU tests run the
    step itself under the runtime guard
    (``test_torch_train_step.py::test_train_step_reads_nothing_on_the_host``)
    and ``chip_smoke.py`` under the card's sync debug mode."""
    import inspect
    from repro_torch.launch import steps
    from repro_torch.models import model_api, transformer
    from repro_torch.optim import adamw
    fns = [steps.TrainStep.__call__, steps.TrainStep._grads,
           steps.TrainStep._fuse, steps.TrainStep._slice,
           steps.TrainStep._gather, steps._value_and_grad, steps._mean_over,
           steps.loss_fn, model_api.train_forward, model_api.param_view,
           model_api.chunked_xent_loss, model_api._chunk_xent,
           transformer.dense_forward, transformer._train_layer,
           transformer._layer_body, adamw.adamw_update,
           adamw.global_norm_sq, adamw._sum_in_order,
           tcomp.compressed_grad_transform]
    pat = re.compile(r"\.item\(|\.cpu\(|\.numpy\(|\.tolist\("
                     r"|(?<![\w.])(float|bool|int)\(")
    for fn in fns:
        src = inspect.getsource(fn)
        hit = pat.search(src)
        assert hit is None, f"{fn.__qualname__}: {hit.group(0)!r}"


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b",
                                  "recurrentgemma-2b", "qwen2-vl-7b",
                                  "whisper-small"])
def test_every_family_defaults_to_the_card(arch, monkeypatch):
    """``get_model`` and the serve launcher raise without a card for every
    family, and run on the CPU when asked."""
    cfg = get_config(arch).smoke_config()
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", arch, "--smoke"])
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "17", "--gen", "3"])
    assert out.tokens.shape == (2, 3)


def test_version():
    assert isinstance(repro_torch.__version__, str)
