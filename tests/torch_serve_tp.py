"""What the ranks of the gloo worlds of ``test_torch_serve_step.py`` and
``test_torch_serve_step_ref.py`` run: the port's ``build_serve_step``
(prefill, then greedy decode steps) on a mesh, and the world of one it is
held to.

Imports the port only (no ``jax``, nothing of ``repro``): the spawned ranks
import it. Inputs arrive as numpy arrays made by the tests from seeds;
results go back as numpy arrays (each rank's rows, every "model" rank's
vocab columns and K/V heads gathered whole).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.steps import build_serve_step
from repro_torch.models.layers import init_from_schema
from repro_torch.models.model_api import schema_for
from repro_torch.sharding import flat_tree
from repro_torch.tensor_parallel import gather_dim

import torch_train_tp as TT

GEN = 4


def full_params(case: str, seed: int = 0) -> dict:
    """The seed's whole leaves of ``case`` in float32, as numpy."""
    cfg = TT.config(case)
    gen = torch.Generator().manual_seed(seed)
    return {k: v.float().numpy() for k, v in
            init_from_schema(schema_for(cfg), gen, "cpu").items()}


def prompts(case: str, batch: int, length: int) -> np.ndarray:
    cfg = TT.config(case)
    return np.random.default_rng(3).integers(0, cfg.vocab, (batch, length))


def aux_inputs(case: str, batch: int) -> dict:
    """The stub inputs of the global batch, float32 from seed 2: qwen2-vl's
    vision embeddings, whisper's frames."""
    cfg = TT.config(case)
    n = (cfg.n_audio_frames if cfg.family == "whisper"
         else cfg.n_vision_tokens)
    if not n:
        return {}
    a = np.random.default_rng(2).normal(size=(batch, n, cfg.d_model))
    key = "frames" if cfg.family == "whisper" else "vision_embeds"
    return {key: torch.from_numpy(a.astype(np.float32))}


def _whole_caches(step, caches):
    """A prefill's caches with every "model" rank's K/V heads or head_dim
    columns (rwkv6: its heads or value columns of ``wkv``; rglru: its LRU
    columns), as numpy (``ServeStep.gather_caches``)."""
    whole = step.gather_caches(caches)
    if isinstance(whole, tuple):
        whole = dict(zip(("k", "v"), whole))
    return {k: t.float().numpy() for k, t in flat_tree(whole).items()}


def serve(mesh, case: str, batch: int, prompt: int, params: dict,
          gen: int = GEN, tokens=None, state_dtype=torch.float32) -> dict:
    """Prefill ``prompt`` tokens of ``batch`` rows, then ``gen`` greedy
    decode steps on ``mesh`` (a cache of prompt + gen rows): this rank's
    rows of the prefill logits (every vocab column), its caches (every K/V
    head), each step's logits and greedy ids, and its final decode state
    (its batch rows, every rank's cache rows or heads)."""
    cfg = TT.config(case)
    pre = build_serve_step(cfg, mesh, ShapeSpec("p", prompt, batch,
                                                "prefill"))
    dec = build_serve_step(cfg, mesh, ShapeSpec("d", prompt + gen, batch,
                                                "decode"))
    p = pre.shard_params({k: torch.from_numpy(v.copy())
                          for k, v in params.items()})
    toks = torch.from_numpy(prompts(case, batch, prompt)
                            if tokens is None else tokens)
    mine = toks[pre.row0:pre.row0 + pre.rows]
    logits, caches = pre(p, mine, aux_inputs(case, batch))
    out = {"rows": (pre.row0, pre.rows),
           "prefill": pre.gather_logits(logits).numpy(),
           "caches": _whole_caches(pre, caches),
           "kv": None if dec.kv.mesh is None else (dec.kv.row0, dec.kv.rows,
                                                  dec.kv.mesh.size)}
    state = dec.to_decode_state(caches, dtype=state_dtype)
    cur = mine[:, -1:]
    steps, ids = [], []
    for i in range(gen):
        lg, state = dec(p, cur, state, prompt + i)
        steps.append(dec.gather_logits(lg).numpy())
        cur = dec.greedy(lg)
        ids.append(cur.numpy())
    out["decode"] = np.stack(steps)
    out["ids"] = np.concatenate(ids, axis=1)
    out["state"] = {k: _whole_rows(dec, k, v).float().numpy()
                    for k, v in flat_tree(state).items()}
    out["shapes"] = {"params": {k: tuple(v.shape) for k, v in p.items()},
                     "state": {k: tuple(v.shape)
                               for k, v in flat_tree(state).items()}}
    return out


def _whole_rows(step, path: str, t):
    """A decode-state leaf with every rank's slice of its third dimension
    (the cache's rows, rwkv6's heads) gathered, its batch rows the
    rank's."""
    axes = step.specs["state"][path][2]
    if axes is None:
        return t
    names = axes if isinstance(axes, tuple) else (axes,)
    return gather_dim(t.contiguous(), step.mesh.axes(names), 2)


def world_cases(_serve_mesh, cases: list, params: dict) -> dict:
    """Each (name, mesh shape, axis names, case, batch, prompt) of
    ``cases`` on this rank: ``serve``'s result."""
    out = {}
    for name, shape, names, case, batch, prompt in cases:
        mesh = (make_host_mesh(model=1, device="cpu") if shape is None
                else make_mesh(shape, names, device="cpu"))
        out[name] = serve(mesh, case, batch, prompt, params[case])
    return out


def stats_cases(_serve_mesh, shape: tuple, names: tuple, cases: list,
                params: dict, batch: int, seq: int) -> dict:
    """The collectives a prefill step and then a decode step (at position
    seq - 1, from the zero state) of each case move on this rank, bf16
    weights: each mesh axis group's calls and bytes by dtype
    (``Mesh.stats``), keyed "axis+axis"."""
    mesh = make_mesh(shape, names, device="cpu")
    out = {}
    for case in cases:
        cfg = TT.config(case)
        for kind in ("prefill", "decode"):
            step = build_serve_step(cfg, mesh, ShapeSpec("x", seq, batch,
                                                         kind))
            p = step.shard_params({k: torch.from_numpy(v.copy()).bfloat16()
                                   for k, v in params[case].items()})
            toks = torch.from_numpy(prompts(case, batch, seq)).int()
            mine = toks[step.row0:step.row0 + step.rows]
            for m in mesh.meshes.values():
                m.stats.reset()
            if kind == "prefill":
                aux = {k: v.bfloat16() for k, v in
                       aux_inputs(case, batch).items()}
                step(p, mine, aux)
            else:
                step(p, mine[:, :1], step.init_state(), seq - 1)
            out[(case, kind)] = {
                "+".join(axes): {k: m.stats.snapshot()[k]
                                 for k in ("calls", "bytes")}
                for axes, m in mesh.meshes.items()}
    return out


def ref_cases(_serve_mesh, meshes: list, cases: tuple, params: dict,
              batch: int, prompt: int) -> dict:
    """``serve`` of each case at each mesh shape of ``meshes`` ((data,
    model)), float32 parameters: one decode step, the state in bf16 as the
    reference's ``init_state`` keeps it."""
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for case in cases:
            out[(case, shape)] = serve(mesh, case, batch, prompt,
                                       params[case], gen=1,
                                       state_dtype=torch.bfloat16)
    return out
