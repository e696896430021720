"""What the ranks of a gloo world run in ``test_torch_train_dist.py`` (the
port's train step over a ``GridMesh``), and the world of one it is held to.

Imports the port only (no ``jax``, nothing of ``repro``): the spawned ranks
import it. Results go back as numpy arrays and Python numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.compression import QuantConfig, compressed_grad_transform
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import GridMesh, Mesh, make_mesh
from repro_torch.launch.steps import TrainStepConfig, build_train_step
from repro_torch.optim import AdamWConfig

ARCH = "granite-3-8b"
SEQ, BATCH = 32, 8
CONVERGE_STEPS, CONVERGE_LR = 12, 2e-3


def local_mesh() -> GridMesh:
    """A ("data", "model") mesh of one rank in a process of a larger world:
    no collective runs on it (every axis has size 1)."""
    one = lambda: Mesh(group=None, size=1, rank=0,
                       device=torch.device("cpu"), backend="none")
    return GridMesh(shape={"data": 1, "model": 1},
                    coords={"data": 0, "model": 0}, rank=0,
                    device=torch.device("cpu"),
                    meshes={("data",): one(), ("model",): one()})


def _np(tree):
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in tree.items()}


def _run(mesh, steps: int, tcfg: TrainStepConfig, seed: int = 1):
    """``steps`` steps from the seed-0 init on ``mesh``: the losses, the
    metrics of the first step, and the state after the last."""
    cfg = get_config(ARCH).smoke_config()
    step = build_train_step(cfg, mesh, ShapeSpec("t", SEQ, BATCH, "train"),
                            tcfg)
    data = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=seed)
    params = step.init_params(0)
    opt = step.init_opt_state(params)
    losses, first = [], None
    for i in range(steps):
        tok, lab = data.global_arrays(i, mesh)
        params, opt, m = step(params, opt, tok, lab)
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: float(v) for k, v in m.items()}
    return {"losses": losses, "first": first, "params": _np(params),
            "opt": opt, "step": step}


def _state_bytes(opt) -> int:
    return sum(v.numel() * v.element_size()
               for key in ("master", "m", "v") for v in opt[key].values())


def train_cases(_serve_mesh, shape: tuple, names: tuple) -> dict:
    """Every case of the test on one rank of a world laid out as ``shape``
    over ``names``."""
    mesh = make_mesh(shape, names, device="cpu")
    out = {"coords": mesh.coords}

    # exact fusion, ZeRO-1: one step, and the whole state gathered back
    exact = _run(mesh, 2, TrainStepConfig())
    st = exact["step"]
    out["exact"] = {"losses": exact["losses"], "first": exact["first"],
                    "params": exact["params"],
                    "opt_full": {k: _np(v) for k, v in st.gather_opt_state(
                        exact["opt"]).items() if k != "step"},
                    "state_bytes": _state_bytes(exact["opt"]),
                    "zero_dims": st.zero_dims}
    if mesh.rank == 0:
        # the world of one on the global batch, a microbatch a rank
        n = int(np.prod(shape))
        one = _run(local_mesh(), 2, TrainStepConfig(microbatches=n))
        out["single"] = {"losses": one["losses"], "first": one["first"],
                         "params": one["params"],
                         "opt_full": {k: _np(v) for k, v in one["opt"].items()
                                      if k != "step"},
                         "state_bytes": _state_bytes(one["opt"])}

    # int8 over "pod": what each axis's collectives carried in one step
    for name in ("pod", "data"):
        if name in mesh.shape:
            mesh.axis(name).stats.reset()
    mesh.axes(st.data_axes).stats.reset()
    int8 = _run(mesh, 1, TrainStepConfig(compression_bits=8))
    out["int8_stats"] = {name: mesh.axis(name).stats.snapshot()
                         for name in ("pod", "data") if name in mesh.shape}
    out["int8_stats"]["zero"] = mesh.axes(st.data_axes).stats.snapshot()
    out["int8_first"] = int8["first"]

    # the two reference reds' intent: 12 steps, exact and int8
    adam = AdamWConfig(lr=CONVERGE_LR)
    out["converge"] = {
        bits: _run(mesh, CONVERGE_STEPS,
                   TrainStepConfig(compression_bits=bits, adamw=adam))["losses"]
        for bits in (None, 8)}
    return out


def grad_transform_cases(_serve_mesh, shape: tuple, names: tuple,
                         grads: list, bits: int, block: int) -> dict:
    """``compressed_grad_transform`` over "pod" twice (the second call fed
    the first's residual) on this rank's gradients ``grads[pod]``."""
    mesh = make_mesh(shape, names, device="cpu")
    pod = mesh.axis("pod")
    mine = {k: torch.from_numpy(v) for k, v in grads[pod.rank].items()}
    res = {k: torch.zeros_like(v) for k, v in mine.items()}
    qc = QuantConfig(bits, block)
    rounds = []
    for _ in range(2):
        red, res, noise = compressed_grad_transform(mine, res, pod, qc)
        rounds.append({"reduced": _np(red), "residual": _np(res),
                       "noise": float(noise)})
    return {"rounds": rounds, "rank": pod.rank,
            "stats": pod.stats.snapshot()}


ZOO_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b", "rwkv6-3b",
             "recurrentgemma-2b", "qwen2-vl-7b", "whisper-small")
ZOO_SEQ, ZOO_BATCH = 32, 4


def zoo_aux(cfg, batch: int, seed: int = 2) -> dict:
    """The stub inputs of ``cfg`` for ``batch`` rows: bf16 from a numpy
    seed (the same on every rank)."""
    rng = np.random.default_rng(seed)
    n = (cfg.n_audio_frames if cfg.family == "whisper"
         else cfg.n_vision_tokens)
    if not n:
        return {}
    key = "frames" if cfg.family == "whisper" else "vision_embeds"
    a = rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)
    return {key: torch.from_numpy(a).to(torch.bfloat16)}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits (NaN compares equal to itself)."""
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}
                  [t.element_size()]).numpy().copy()


def zoo_cases(_serve_mesh, archs: tuple) -> dict:
    """One step of each family's smoke config on this rank of a (pod=2,
    data=1, model=1) world, from the seed-0 init and the same batch:
    exact (functional), exact donated (in place) and int8 over "pod"
    donated. Returns per family the losses, whether the donated step
    gave the functional one's bits, and the parameters (float32 numpy)."""
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    out = {}
    for arch in archs:
        cfg = get_config(arch).smoke_config()
        shape = ShapeSpec("z", ZOO_SEQ, ZOO_BATCH, "train")
        data = SyntheticLMData(cfg.vocab, ZOO_SEQ, ZOO_BATCH, seed=1)
        tok, lab = data.global_arrays(0, mesh)
        aux = zoo_aux(cfg, ZOO_BATCH)
        res = {}
        for name, bits, donate in (("exact", None, False),
                                   ("exact_donated", None, True),
                                   ("int8", 8, True)):
            step = build_train_step(cfg, mesh, shape, TrainStepConfig(
                compression_bits=bits, moe_groups=2))
            params = step.init_params(0)
            opt = step.init_opt_state(params)
            mesh.axis("pod").stats.reset()
            p2, o2, m = step(params, opt, tok, lab, aux, donate=donate)
            if donate:
                assert p2 is params and o2 is opt
            res[name] = {"loss": float(m["loss"]),
                         "quant_noise": float(m["quant_noise"]),
                         "params": _np(p2),
                         "bits": {k: _bits(v) for k, v in p2.items()},
                         "opt_bits": {key: {k: _bits(v) for k, v in
                                            o2[key].items()}
                                      for key in ("master", "m", "v")},
                         "pod": mesh.axis("pod").stats.snapshot()}
        out[arch] = res
    return out
