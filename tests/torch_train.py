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
