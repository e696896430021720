"""The model interface of the port, over every family of the JAX package:
``dense`` (gemma3, glm4, granite, yi, qwen2-vl) and ``moe`` (qwen3-moe,
mixtral) in ``transformer``, ``rwkv6``, ``rglru`` (recurrentgemma) and
``whisper``, for serving (prefill and decode) and training
(``train_forward``, ``chunked_xent_loss``).

One ``nn.Module`` per family, all ``ModelBundle``s:

    model.forward(tokens, mode, **aux)      -> (hidden, caches / state)
    model.decode_step(tokens, state, pos)   -> (hidden, state)
    model.init_state(batch, max_len)        -> decode cache / state
    model.aux_inputs(batch, seq)            -> stub-frontend inputs (meta tensors)
    model.logits(hidden)                    -> float32 vocab logits

Parameters are registered one to one with the reference schema's paths,
each '/' a module level: ``embed/table`` is ``embed.table``; a path stacked
over a depth (``layers/*``, rglru's ``macro/*/*``, whisper's ``enc/*/*`` and
``dec/*/*``) is split into views per slice, slice ``i`` of
``macro/rec0/w_in`` being ``macro.rec0.<i>.w_in`` (``state_from_flat``);
rglru's ``tail<i>/*`` are not stacked. They are inference weights
(``requires_grad=False``).

Training works on the flat dict itself (path -> stacked tensor, the
optimizer's and the checkpoint's leaves): ``param_view`` gives the same
module-shaped access to it with the per-layer slices taken as autograd
views, so the gradient of a loss reaches each stacked leaf whole.
"""
from __future__ import annotations

import math
import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import rglru, rwkv6, transformer, whisper
from .layers import init_from_schema

__all__ = ["ModelBundle", "DenseLM", "RWKV6LM", "RGLRULM", "WhisperLM",
           "get_model", "lm_logits", "state_from_flat", "schema_for",
           "resolve_device", "param_view", "train_forward",
           "chunked_xent_loss"]


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


_SCHEMAS = {"dense": transformer.dense_schema,
            "moe": transformer.dense_schema,
            "rwkv6": rwkv6.rwkv6_schema,
            "rglru": rglru.rglru_schema,
            "whisper": whisper.whisper_schema}


def schema_for(cfg: ModelConfig) -> dict:
    if cfg.family not in _SCHEMAS:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return _SCHEMAS[cfg.family](cfg)


def _depth(group: str, cfg: ModelConfig) -> int | None:
    """The stacked depth of a path's first group, None if not stacked."""
    return {"layers": cfg.n_layers, "macro": rglru.macro_count(cfg)[0],
            "enc": cfg.n_enc_layers, "dec": cfg.n_layers}.get(group)


def _names(path: str, cfg: ModelConfig) -> list[str]:
    """The module names of a schema path: one per slice of a stacked path
    (the index after its group: ``layers.3.wq``, ``macro.rec0.3.w_in``),
    else the path with '/' as '.'."""
    *groups, leaf = path.split("/")
    n = _depth(groups[0], cfg)
    if n is None:
        return [".".join(groups + [leaf])]
    return [".".join(groups + [str(i), leaf]) for i in range(n)]


def state_from_flat(flat: dict, cfg: ModelConfig) -> dict:
    """The module state (name -> tensor) of a flat reference-style dict
    (path -> tensor, stacked weights on a leading axis): stacked paths are
    split into views per slice, other paths renamed."""
    state = {}
    for path, t in flat.items():
        names = _names(path, cfg)
        stacked = _depth(path.split("/")[0], cfg) is not None
        if stacked and t.shape[0] != len(names):
            raise ValueError(f"{path}: {tuple(t.shape)} has no leading "
                             f"axis of {len(names)}")
        state.update(zip(names, t.unbind(0) if stacked else [t]))
    return state


def _tree(state: dict) -> dict:
    """Module names -> a nested dict of their groups (keys are the names'
    parts)."""
    root: dict = {}
    for name, t in state.items():
        *parts, leaf = name.split(".")
        node = root
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = t
    return root


def _module(node: dict) -> nn.Module:
    """The module of one group: its tensors as parameters (``_Params``), a
    ``ModuleList`` of numbered slices, or a module of named subgroups."""
    if all(isinstance(v, torch.Tensor) for v in node.values()):
        return _Params(node)
    if all(k.isdigit() for k in node):
        return nn.ModuleList(_module(node[str(i)]) for i in range(len(node)))
    mod = nn.Module()
    for key, sub in node.items():
        mod.add_module(key, _module(sub))
    return mod


class ModelBundle(nn.Module):
    """What every family's module has: its config and schema, and one
    submodule per top-level group of the schema (``embed``, ``final_norm``,
    ``layers``, an untied ``lm_head``, ...)."""

    def __init__(self, cfg: ModelConfig, state: dict):
        super().__init__()
        self.cfg = cfg
        self.schema = schema_for(cfg)
        want = {n for p in self.schema for n in _names(p, cfg)}
        if set(state) != want:
            raise ValueError(f"state does not match the {cfg.name} schema: "
                             f"missing {sorted(want - set(state))}, "
                             f"unexpected {sorted(set(state) - want)}")
        for key, node in _tree(state).items():
            self.add_module(key, _module(node))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        """The weights' and activations' dtype (bf16 as the reference's)."""
        return self.embed.table.dtype

    def logits(self, hidden):
        return lm_logits(self, hidden)

    def aux_inputs(self, batch: int, seq: int) -> dict:
        """Stub-frontend inputs the forward takes besides the tokens, as
        meta tensors (shape and dtype): whisper's post-conv ``frames``,
        qwen2-vl's ``vision_embeds``; none for the other families (the
        reference's ``ModelBundle.aux_inputs``)."""
        del seq
        cfg = self.cfg
        meta = lambda n: torch.empty((batch, n, cfg.d_model),
                                     dtype=torch.bfloat16, device="meta")
        if cfg.family == "whisper":
            return {"frames": meta(cfg.n_audio_frames)}
        if cfg.n_vision_tokens:
            return {"vision_embeds": meta(cfg.n_vision_tokens)}
        return {}


class DenseLM(ModelBundle):
    """Decoder-only transformer, dense or MoE (``models/transformer.py``)."""

    def forward(self, tokens, mode: str = "prefill", vision_embeds=None):
        return transformer.dense_forward(self, tokens, self.cfg, mode,
                                         vision_embeds)

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


class RGLRULM(ModelBundle):
    """RecurrentGemma / Griffin (``models/rglru.py``)."""

    def forward(self, tokens, mode: str = "prefill", state=None):
        return rglru.rglru_forward(self, tokens, self.cfg, mode, state)

    def decode_step(self, tokens, state, pos: int):
        return rglru.rglru_decode_step(self, tokens, state, pos, self.cfg)

    def init_state(self, batch: int, max_len: int):
        return rglru.rglru_init_state(self.cfg, batch, max_len, self.device,
                                      self.dtype)


class WhisperLM(ModelBundle):
    """Whisper encoder-decoder (``models/whisper.py``)."""

    def forward(self, tokens, mode: str = "prefill", frames=None):
        return whisper.whisper_forward(self, tokens, self.cfg, mode, frames)

    def decode_step(self, tokens, state, pos: int):
        return whisper.whisper_decode_step(self, tokens, state, pos, self.cfg)

    def init_state(self, batch: int, max_len: int):
        return whisper.whisper_init_cache(self.cfg, batch, max_len,
                                          dtype=self.dtype, device=self.device)


_FAMILIES = {"dense": DenseLM, "moe": DenseLM, "rwkv6": RWKV6LM,
             "rglru": RGLRULM, "whisper": WhisperLM}


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


# -- training -------------------------------------------------------------------

def _view(node: dict):
    if all(isinstance(v, torch.Tensor) for v in node.values()):
        return types.SimpleNamespace(**node)
    if all(k.isdigit() for k in node):
        return [_view(node[str(i)]) for i in range(len(node))]
    return types.SimpleNamespace(**{k: _view(v) for k, v in node.items()})


def param_view(params: dict, cfg: ModelConfig):
    """The flat parameter dict ``params`` (path -> tensor, stacked paths on
    a leading axis) with a model's attribute access (``view.embed.table``,
    ``view.layers[i].wq``): a stacked leaf's slices are views of it, so
    autograd carries their gradients to the leaf."""
    want = set(schema_for(cfg))
    if set(params) != want:
        raise ValueError(f"params do not match the {cfg.name} schema: "
                         f"missing {sorted(want - set(params))}, "
                         f"unexpected {sorted(set(params) - want)}")
    return _view(_tree(state_from_flat(params, cfg)))


def train_forward(params: dict, tokens, cfg: ModelConfig,
                  remat: bool = True, n_groups: int = 16, **aux):
    """The training forward of the flat ``params`` over ``tokens`` (B, S):
    the final hidden (B, S, D), every family dispatched as the reference's
    ``get_model`` does. ``n_groups``: the MoE layers' token groups (the
    step's ``moe_groups``); ``aux``: the stub inputs ``aux_inputs``
    describes (whisper's ``frames``, qwen2-vl's ``vision_embeds``)."""
    view = param_view(params, cfg)
    if cfg.family in ("dense", "moe"):
        hidden, _ = transformer.dense_forward(
            view, tokens, cfg, "train", aux.get("vision_embeds"), remat,
            n_groups)
    elif cfg.family == "rwkv6":
        hidden, _ = rwkv6.rwkv6_forward(view, tokens, cfg, "train",
                                        remat=remat)
    elif cfg.family == "rglru":
        hidden, _ = rglru.rglru_forward(view, tokens, cfg, "train",
                                        remat=remat)
    elif cfg.family == "whisper":
        hidden, _ = whisper.whisper_forward(view, tokens, cfg, "train",
                                            aux.get("frames"), remat)
    else:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return hidden


def _chunk_xent(hc, lc, mc, table, vocab_ok):
    """Summed cross-entropy of one chunk: float32 logits of bf16 operands,
    the padded vocab at -inf."""
    logits = torch.matmul(hc.to(torch.bfloat16).float(), table.float().T)
    logits = torch.where(vocab_ok, logits, -math.inf)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, lc[..., None].long(), dim=-1)[..., 0]
    return ((lse - gold) * mc).sum()


def chunked_xent_loss(params: dict, hidden, labels, cfg: ModelConfig,
                      chunk: int = 512, label_mask=None):
    """Mean cross-entropy of ``hidden`` (B, S, D) against ``labels`` (B, S)
    without materialising (B, S, V) logits: over sequence chunks of at most
    ``chunk`` (the largest that divides S), each chunk's logits recomputed
    in backward (a checkpoint: no (B, chunk, V) tensor is saved for
    backward, the reason the reference checkpoints its scan body). The
    padded vocab is masked to -inf; ``label_mask`` (B, S) weights the
    tokens; sum / max(count, 1). ``params`` is the flat parameter dict."""
    table = params.get("lm_head/table", params["embed/table"])
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    if label_mask is None:
        label_mask = torch.ones(labels.shape, dtype=torch.float32,
                                device=hidden.device)
    vocab_ok = torch.arange(cfg.vocab_padded, device=hidden.device) < cfg.vocab
    tot = cnt = None
    for i0 in range(0, s, chunk):
        sl = slice(i0, i0 + chunk)
        mc = label_mask[:, sl].to(torch.float32)
        loss = checkpoint(_chunk_xent, hidden[:, sl], labels[:, sl], mc,
                          table, vocab_ok, use_reentrant=False,
                          preserve_rng_state=False)
        tot = loss if tot is None else tot + loss
        cnt = mc.sum() if cnt is None else cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
