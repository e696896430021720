"""The model interface of the port, over the families whose serving path
runs here: ``dense`` (gemma3, glm4, granite, yi) and ``rwkv6``.

One ``nn.Module`` per family, both ``ModelBundle``s:

    model.forward(tokens, mode)             -> (hidden, caches / state)
    model.decode_step(tokens, state, pos)   -> (hidden, state)
    model.init_state(batch, max_len)        -> decode cache / state
    model.logits(hidden)                    -> float32 vocab logits

Parameters are registered one to one with the reference schema's paths:
``embed/table`` is ``embed.table``, ``final_norm/w`` is ``final_norm.w``,
and layer ``i``'s slice of a stacked ``layers/<name>`` is
``layers.<i>.<name>`` (``state_from_flat``). They are inference weights
(``requires_grad=False``): training waits.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import rwkv6, transformer
from .layers import init_from_schema

__all__ = ["ModelBundle", "DenseLM", "RWKV6LM", "get_model", "lm_logits",
           "state_from_flat", "schema_for", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA one must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class _Params(nn.Module):
    """A group of parameters named by the reference schema's leaf names."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def schema_for(cfg: ModelConfig) -> dict:
    if cfg.family == "dense":
        return transformer.dense_schema(cfg)
    if cfg.family == "rwkv6":
        return rwkv6.rwkv6_schema(cfg)
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported (only 'dense' and "
        "'rwkv6' serve in this package)")


def _names(path: str, n_layers: int) -> list[str]:
    """The module names of a schema path (one per layer for ``layers/*``)."""
    group, leaf = path.split("/", 1)
    if group == "layers":
        return [f"layers.{i}.{leaf}" for i in range(n_layers)]
    return [f"{group}.{leaf}"]


def state_from_flat(flat: dict, cfg: ModelConfig) -> dict:
    """The module state (name -> tensor) of a flat reference-style dict
    (path -> tensor, per-layer weights stacked on a leading axis): stacked
    ``layers/*`` are split into views per layer, other paths renamed."""
    state = {}
    for path, t in flat.items():
        stacked = path.startswith("layers/")
        if stacked and t.shape[0] != cfg.n_layers:
            raise ValueError(f"{path}: {tuple(t.shape)} has no leading "
                             f"axis of {cfg.n_layers} layers")
        state.update(zip(_names(path, cfg.n_layers),
                         t.unbind(0) if stacked else [t]))
    return state


class ModelBundle(nn.Module):
    """What every family's module has: its config and schema, the embedding
    and final norm, per-layer parameter groups, an optional untied head."""

    def __init__(self, cfg: ModelConfig, state: dict):
        super().__init__()
        self.cfg = cfg
        self.schema = schema_for(cfg)
        want = {n for p in self.schema for n in _names(p, cfg.n_layers)}
        if set(state) != want:
            raise ValueError(f"state does not match the {cfg.name} schema: "
                             f"missing {sorted(want - set(state))}, "
                             f"unexpected {sorted(set(state) - want)}")
        groups: dict = {}
        for name, t in state.items():
            *head, leaf = name.split(".")
            groups.setdefault(".".join(head), {})[leaf] = t
        self.embed = _Params(groups["embed"])
        self.final_norm = _Params(groups["final_norm"])
        if "lm_head" in groups:
            self.lm_head = _Params(groups["lm_head"])
        self.layers = nn.ModuleList(_Params(groups[f"layers.{i}"])
                                    for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        """The weights' and activations' dtype (bf16 as the reference's)."""
        return self.embed.table.dtype

    def logits(self, hidden):
        return lm_logits(self, hidden)


class DenseLM(ModelBundle):
    """Decoder-only dense transformer (``models/transformer.py``)."""

    def forward(self, tokens, mode: str = "prefill"):
        return transformer.dense_forward(self, tokens, self.cfg, mode)

    def decode_step(self, tokens, state, pos: int):
        return transformer.dense_decode_step(self, tokens, state, pos, self.cfg)

    def init_state(self, batch: int, max_len: int):
        return transformer.init_cache(self.cfg, batch, max_len,
                                      dtype=self.dtype, device=self.device)


class RWKV6LM(ModelBundle):
    """RWKV-6 Finch (``models/rwkv6.py``)."""

    def forward(self, tokens, mode: str = "prefill", state=None):
        return rwkv6.rwkv6_forward(self, tokens, self.cfg, mode, state)

    def decode_step(self, tokens, state, pos: int):
        return rwkv6.rwkv6_decode_step(self, tokens, state, pos, self.cfg)

    def init_state(self, batch: int, max_len: int):
        del max_len
        return rwkv6.rwkv6_init_state(self.cfg, batch, self.device, self.dtype)


_FAMILIES = {"dense": DenseLM, "rwkv6": RWKV6LM}


def get_model(cfg: ModelConfig, device="cuda", seed: int = 0,
              state: dict | None = None) -> ModelBundle:
    """The family's module on ``device`` (the card unless asked otherwise;
    raises without one). Weights: ``state`` (as ``state_from_flat`` or
    ``convert.lm_params_from_arrays`` give it) or, without one, a random
    init from the schema drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    dev = resolve_device(device)
    schema = schema_for(cfg)
    if state is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = state_from_flat(init_from_schema(schema, gen, dev), cfg)
    else:
        state = {name: t.to(dev) for name, t in state.items()}
    return _FAMILIES[cfg.family](cfg, state)


def lm_logits(model: ModelBundle, hidden):
    """Full float32 logits (B, S, V_padded) of hidden (B, S, D): bf16
    operands, float32 products and sums, as the reference's
    ``preferred_element_type=float32``."""
    head = getattr(model, "lm_head", model.embed)
    return torch.matmul(hidden.float(), head.table.float().T)
